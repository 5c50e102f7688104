"""h2d_ms.embed: the device time of host-to-device copies a batch of
the engine's batch size, from the profiler's memcpy records."""


def read(rec, run):
    if rec is None:
        return None
    seconds = rec.copy_seconds("HtoD")
    if seconds <= 0:
        return None
    return 1e3 * seconds / run["info"]["batches"]

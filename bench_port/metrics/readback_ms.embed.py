"""readback_ms.embed: the host ms a batch in the engine's
``engine.readback`` span (harness/program.py): the wait for the batch,
queued behind the next batch's kernels, and its copy back, the mean over
the window's batches."""

from harness import program


def read(rec, run):
    if rec is None or rec.busy_s <= 0:
        return None
    return program.host_ms(rec, "engine.readback")

"""stage_idle.embed: the device-idle time inside the engine's
``engine.stage`` spans (harness/program.py), as a share of the traced
window: what the card waits while the host stages a batch."""

from harness import program


def read(rec, run):
    if rec is None or rec.busy_s <= 0 or rec.window_s <= 0:
        return None
    spans = program.named(rec, "engine.stage")
    if not spans:
        return None
    idle = program.idle_s(rec, [(s.start_ns, s.end_ns) for s in spans])
    return 100.0 * idle / rec.window_s

"""stage_ms.embed: the host ms a batch in the engine's ``engine.stage``
span, the copy of a host batch into a pinned buffer (the program's own
span; harness/program.py), the mean over the window's batches."""

from harness import program


def read(rec, run):
    if rec is None or rec.busy_s <= 0:
        return None
    return program.host_ms(rec, "engine.stage")

"""assemble_ms.search: the host ms a query batch in the store's
``store.assemble`` span (harness/program.py): the distance convention
and the ids, distances and metadata lists, the mean over the window's
batches."""

from harness import program


def read(rec, run):
    if rec is None or rec.busy_s <= 0:
        return None
    return program.host_ms(rec, "store.assemble")

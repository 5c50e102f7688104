"""readback_ms.search: the host ms a query batch in the store's
``store.readback`` span (harness/program.py): the wait for the device
top-k's sort and the copies of scores and ids back, the mean over the
window's batches."""

from harness import program


def read(rec, run):
    if rec is None or rec.busy_s <= 0:
        return None
    return program.host_ms(rec, "store.readback")

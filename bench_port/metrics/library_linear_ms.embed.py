"""library_linear_ms.embed: the device ms a batch of the kernels of group
``linear`` other than the port's ``gemm_f32_wg``: the library's products
(cuBLAS f32), which ops/linear.py's rule sends there for their K or N
(SigLIP's 4,304-wide MLP: fc1's N, fc2's K), with the few short ones of
the attention-pooling head beside them. Silent unless the window's
``linear_declined_shape`` (ops/linear.py's ``route.declined_shape``, in
the entry's launch counts) is two a layer a batch, the MLP's two products
in every layer: a program that counts none, or runs them elsewhere, reads
nothing here."""

from harness import trace

KERNEL = "gemm_f32_wg"


def read(rec, run):
    if rec is None or rec.busy_s <= 0:
        return None
    info = run["info"]
    counted = info.get("launches", {}).get("linear_declined_shape", 0)
    batches = info.get("batches", 0)
    layers = run["config"]["num_hidden_layers"]
    if not batches or counted != 2 * layers * batches:
        return None
    seconds = 0.0
    for name, s, t in rec.kernels:
        if (KERNEL in name or t <= rec.lo or s >= rec.hi
                or trace.group_of(name, rec.groups) != "linear"):
            continue
        seconds += (min(t, rec.hi) - max(s, rec.lo)) / 1e9
    return 1e3 * seconds / batches

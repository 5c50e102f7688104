"""Kernel attribution by the files under kernel_groups/, and the
reductions of a trace, on hand-made records."""

import shutil

import pytest
import torch

from harness import manifest, runner, trace

# names as torch.profiler printed them on the card
GEMM = ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
        "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas")
B = ("(anonymous namespace)::attn_f32_wg(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::F32WgParams)")
A = ("void (anonymous namespace)::patch_embed_wg<float>(CUtensorMap_st, "
     "PatchGeometry, float const*, float*, long long, int, bool, int, int)")
LN = ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
      "<float, float, false>(int, float, float const*)")
GELU = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
        "GeluCUDAKernelImpl(at::TensorIteratorBase&, at::native::GeluType)")
SORT = ("void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<at_cuda_"
        "detail::cub::DeviceRadixSortPolicy<float, long, int>::Policy900>")
ADD = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
       "CUDAFunctor_add<float>, std::array<char*, 3ul> >")


def test_groups_of_the_cards_kernels():
    groups = trace.load_groups()
    want = {GEMM: "linear", B: "attn", A: "patch_embed", LN: "layernorm",
            GELU: "gelu", SORT: "sort", ADD: "other"}
    assert {k: trace.group_of(k, groups) for k in want} == want


def test_a_new_file_extends_a_group(tmp_path):
    shutil.copytree(manifest.BENCH_DIR / "kernel_groups",
                    tmp_path / "kernel_groups")
    assert trace.group_of(ADD, trace.load_groups(tmp_path)) == "other"
    (tmp_path / "kernel_groups" / "gelu" / "adds.txt").write_text(
        "# the residual adds\nCUDAFunctor_add\n")
    groups = trace.load_groups(tmp_path)
    assert trace.group_of(ADD, groups) == "gelu"
    assert trace.group_of(GEMM, groups) == "linear"
    (tmp_path / "kernel_groups" / "residual").mkdir()
    (tmp_path / "kernel_groups" / "residual" / "add.txt").write_text(
        "CUDAFunctor_add<float>\n")
    # the longer match, of the new group, wins
    assert trace.group_of(ADD, trace.load_groups(tmp_path)) == "residual"


class _Ev:
    def __init__(self, name, start, dur, cuda, thread=1):
        self._n, self._s, self._d = name, start, dur
        self._dev = (torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU)
        self._t = thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def start_thread_id(self):
        return self._t


def _records():
    us = 1000
    ev = [_Ev("bench.embed_batch", 0, 1000 * us, False),
          _Ev("aten::copy_", 100 * us, 300 * us, False),
          _Ev("bench.embed_batch", 0, 1000 * us, True),  # its device range
          _Ev(GEMM, 0, 100 * us, True),
          _Ev("Memcpy HtoD (Pinned -> Device)", 400 * us, 50 * us, True),
          _Ev(B, 450 * us, 250 * us, True),
          _Ev(GEMM, 690 * us, 110 * us, True)]  # overlaps B by 10 us
    return trace.Records(ev, trace.load_groups())


def test_busy_idle_and_groups():
    r = _records()
    assert r.window_s == 1e-3
    # 0-100, 400-800: 500 us busy
    assert abs(r.busy_s - 5e-4) < 1e-12
    g = r.group_seconds()
    assert abs(g["linear"] - 2.1e-4) < 1e-12 and abs(g["attn"] - 2.5e-4) < 1e-12
    assert abs(r.copy_seconds("HtoD") - 5e-5) < 1e-12
    assert r.busy_within_spans("embed_batch") == [(1e-3, r.busy_s)]
    ops = dict(r.device_ops())
    assert abs(ops[GEMM[:160]] - 2.1e-4) < 1e-12


def test_idle_gaps_labelled_by_the_host():
    gaps = dict(trace.Records.idle_gaps(_records()))
    # 100-400 us: the host was in the pinned copy; 800-1000: in Python
    assert abs(gaps["embed_batch > aten::copy_"] - 3e-4) < 1e-12
    assert abs(gaps["embed_batch > Python"] - 2e-4) < 1e-12


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    manifest.load()["per_layer"]])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    r = trace.Records([], trace.load_groups())
    assert r.window_s == 0 and r.busy_s == 0 and r.group_seconds() == {}
    facts = {"info": {"batches": 3, "flops_per_frame": 1.0,
                      "linear_bound_s": 1.0, "attention_bound_s": 1.0,
                      "query_flops": 1.0, "query_bound_s": 1.0,
                      "dtype": "float32"},
             "units": 10, "window_s": 1.0}
    assert runner._reader(metric)(r, facts) is None
    assert runner._reader(metric)(None, facts) is None

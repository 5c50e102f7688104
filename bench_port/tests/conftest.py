"""The benchmark's own tests: CPU, tiny sizes, the port's plain paths.
Tests marked ``cuda`` need the card and skip without one.

    python -m pytest bench_port/tests -q            # here, on the CPU
    python -m pytest bench_port/tests -q -m cuda    # on the card
"""

import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

#: a ViT small enough for the CPU, with every part of the real one
TINY_VIT = {"hidden_size": 32, "num_hidden_layers": 2,
            "num_attention_heads": 2, "intermediate_size": 64, "batch": 4}
TINY = {
    "embed-b16-f32": (dict(TINY_VIT, image_size=32, patch_size=8),
                      {"pool_frames": 8, "sample_rows_per_call": 4}),
    # 28 rows at patch 8: the last 4 pixel rows fill no patch (cropped)
    "embed-b32-432-f32": (dict(TINY_VIT, image_size=[28, 40], patch_size=8),
                          {"pool_frames": 8, "sample_rows_per_call": 4}),
    "search-200k-f32": ({"hidden_size": 32},
                        {"rows": 3000, "queries": 16, "query_batches": 4,
                         "k": 5, "warmup_batches": 1, "sample_within": 4,
                         "sample_batches": 2, "run_frames": [5, 40]}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

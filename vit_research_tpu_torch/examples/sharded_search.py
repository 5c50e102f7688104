"""Mesh-sharded exact vector search: the path for corpora larger than one
device's memory.

Port of examples/sharded_search.py: ops/sharded_topk.py behind
``Collection.shard_device``. The corpus rows live sharded over the
device mesh (each entry holds rows / n_dev and scores its shard; the
per-shard winners merge on the first entry), and the results equal the
single-device path's exactly, tie order included.

    python -m vit_research_tpu_torch.examples.sharded_search
    python -m vit_research_tpu_torch.examples.sharded_search --tiny \\
        --device cpu

The mesh has 8 entries of ``--device``: a mesh may name one device more
than once, so one card (or the CPU) runs every sharded path. The default
is the JAX walkthrough's corpus, 100,000 x 256 int8 rows; ``--tiny`` an
8,192 x 64 one, still large enough (rows x queries >= 2^14) for the flat
query to take the device route it is compared with.
"""

from __future__ import annotations

import sys

import numpy as np

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.examples import _engines

MESH_ENTRIES = 8


def corpus_and_queries(tiny: bool):
    """The seeded corpus and 5 noisy copies of its first rows."""
    n, d = (8192, 64) if tiny else (100_000, 256)
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = corpus[:5] + 0.01 * rng.normal(size=(5, d)).astype(np.float32)
    return corpus, queries


def main(argv=None) -> dict:
    """Query flat, then sharded; returns both answers, a filtered one,
    the corpus and the queries. Raises if the sharded answer differs."""
    from vit_research_tpu_torch.parallel.mesh import make_mesh
    from vit_research_tpu_torch.store.vector_store import Collection

    args = _engines.parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    mesh = make_mesh(devices=[dev] * MESH_ENTRIES)
    n_dev = mesh.devices.size
    corpus, queries = corpus_and_queries(args.tiny)
    n, d = corpus.shape

    col = Collection("demo", space="cosine", device_quant="int8",
                     device=dev)
    col.upsert([f"row{i}" for i in range(n)], corpus,
               [{"bucket": i % 4} for i in range(n)])
    baseline = col.query(queries, n_results=4)

    col.shard_device(mesh)  # each entry now holds ~n/n_dev int8 rows
    sharded = col.query(queries, n_results=4)
    if sharded["ids"] != baseline["ids"]:
        raise AssertionError("the sharded path must be exact: "
                             f"{sharded['ids']} != {baseline['ids']}")
    print(f"{n} x {d} int8 corpus sharded over {n_dev} entries of {dev} "
          f"(~{n // n_dev} rows an entry)")
    for qi, ids in enumerate(sharded["ids"]):
        print(f"  query {qi}: {ids}  (expected nearest: row{qi})")

    filtered = col.query(queries[:1], n_results=4,
                         where={"bucket": {"$eq": 0}})
    if not all(int(i[3:]) % 4 == 0 for i in filtered["ids"][0]):
        raise AssertionError(f"filter ignored: {filtered['ids']}")
    print(f"  filtered (bucket=0): {filtered['ids'][0]}")
    return {"corpus": corpus, "queries": queries, "flat": baseline,
            "sharded": sharded, "filtered": filtered, "mesh": mesh}


if __name__ == "__main__":
    main(sys.argv[1:])

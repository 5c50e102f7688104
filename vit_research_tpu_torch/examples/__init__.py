"""Runnable walkthroughs of the port, one module each, run as
``python -m vit_research_tpu_torch.examples.<name>``:

- ``full_pipeline``: frames -> embeddings -> temporal-head segmentation ->
  clips -> chunks -> frame store -> stage-1 encoder -> RATT collection ->
  stage-2 training -> per-clip event rows;
- ``live_segmentation``: clips surfacing mid-game, from the library
  stream and from a daemon session over the unix socket;
- ``serving``: one warm daemon serving embed / query / stats, a scored
  segment session and two concurrent ``segment --follow --socket`` games;
- ``sharded_search``: the exact int8 top-k sharded over a device mesh,
  equal to the flat path;
- ``pod_embedding``: two processes, each embedding its shard of a frame
  list, the embeddings gathered to both;
- ``quality_fast_profile``: the fast profile's quality dossier (fidelity,
  segmentation, retrieval and event metrics of ToMe, int8-static and
  strided embedding against the parity engine).

Each takes ``--device`` (default ``cuda``, which raises without a card)
and ``--tiny`` (the tiny test ViT and 32 x 32 frames, for the CPU); the
default is full width: the seeded ViT-B/16 @224, the default chunk
encoder and heads. Each ``main(argv)`` returns what it computed, so a
caller can check it.
"""

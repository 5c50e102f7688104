"""Command line of the port.

    python -m vit_research_tpu_torch.cli write-frame-db FRAMES \\
        --manual-csv M.csv --db DB --collection C [--device cuda]
    python -m vit_research_tpu_torch.cli segment FRAMES --method knn-hmm \\
        --db DB --corpus-collection C --out OUT --vid N [--write-back] \\
        [--transitions T.json] [--follow] [--device cuda]
    python -m vit_research_tpu_torch.cli segment FRAMES --method knn-hmm \\
        --follow --socket S --out OUT --vid N
    python -m vit_research_tpu_torch.cli segment FRAMES --method streaks \\
        --db DB --corpus-collection C --out OUT --vid N [--device cuda]
    python -m vit_research_tpu_torch.cli tune-segment FRAMES \\
        --manual-csv M.csv --db DB --corpus-collection C [--out T.json]
    python -m vit_research_tpu_torch.cli serve --socket S [--db DB \\
        --collection C] [--warmup] [--device cuda]
    python -m vit_research_tpu_torch.cli serve-ctl ping|stats|reload|\\
        shutdown --socket S
    python -m vit_research_tpu_torch.cli build-frame-store \\
        --clip-root 'clips_{vid}' --vids N [N ...] [--clip-labels L.csv] \\
        --out STORE [--device cuda]
    python -m vit_research_tpu_torch.cli search FRAME [FRAME ...] \\
        --db DB --collection C [--k 10] [--where JSON] [--device cuda]
    python -m vit_research_tpu_torch.cli db-info DB [--compact]
    python -m vit_research_tpu_torch.cli train-stage1 --store STORE \
        --ckpt CKPT [--epochs 10] [--run-id R [--resume]] [--device cuda]
    python -m vit_research_tpu_torch.cli write-ratt-db --store STORE \
        --ckpt CKPT --db DB [--collection ratt_db] [--run-id R] \
        [--device cuda]
    python -m vit_research_tpu_torch.cli self-label FRAMES --db DB \
        --collection C --out LABELS.csv [--upsert] [--device cuda]
    python -m vit_research_tpu_torch.cli finalize-clips --clips CLIPS \
        --db DB --collection C --out OUT [--k 5] [--device cuda]
    python -m vit_research_tpu_torch.cli merge-clips --clips CLIPS \
        --frame-pool FRAMES --out OUT [--max-gap 30]
    python -m vit_research_tpu_torch.cli clustering --db DB --collection C \
        --out SIDE.npz [--epochs 50] [--device cuda]
    python -m vit_research_tpu_torch.cli fresh-test FRAMES --params SIDE.npz \
        --out OUT [--device cuda]
    python -m vit_research_tpu_torch.cli write-embeddings FRAMES \
        --manual-csv M.csv --out-template 'out/{cls}_embeddings.npz' \
        [--device cuda]
    python -m vit_research_tpu_torch.cli extract-frames VIDEO --out FRAMES \
        --vid N [--height 1080 --width 1920] [--every 1] [--start S --end E]

The verbs take the reference CLI's arguments, print its outputs and read
and write the same vector-store and frame-store formats; ``--device``
picks the torch device (default ``cuda``) of the verbs that embed, rank
or train. ``VRT_TINY=1`` swaps the
ViT-B/16 for the reference's tiny test ViT and ``VRT_GRAYSCALE=1`` embeds
luminance frames, as in the reference. The arcs follow the reference's
layout: :mod:`.ingest`, :mod:`.segment_cmds`, :mod:`.db_cmds`,
:mod:`.train_cmds`, :mod:`.serve_cmds`, with the shared helpers in
:mod:`.common`.
"""

from vit_research_tpu_torch.cli.parser import main  # noqa: F401

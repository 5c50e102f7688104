"""Command line of the port.

    python -m vit_research_tpu_torch.cli write-frame-db FRAMES \\
        --manual-csv M.csv --db DB --collection C [--device cuda]
    python -m vit_research_tpu_torch.cli segment FRAMES --method knn-hmm \\
        --db DB --corpus-collection C --out OUT --vid N [--write-back] \\
        [--transitions T.json] [--device cuda]
    python -m vit_research_tpu_torch.cli build-frame-store \\
        --clip-root 'clips_{vid}' --vids N [N ...] [--clip-labels L.csv] \\
        --out STORE [--device cuda]
    python -m vit_research_tpu_torch.cli search FRAME [FRAME ...] \\
        --db DB --collection C [--k 10] [--where JSON] [--device cuda]
    python -m vit_research_tpu_torch.cli db-info DB [--compact]

The verbs take the reference CLI's arguments, print its outputs and read
and write the same vector-store and frame-store formats; ``--device``
picks the torch device (default ``cuda``). ``VRT_TINY=1`` swaps the
ViT-B/16 for the reference's tiny test ViT and ``VRT_GRAYSCALE=1`` embeds
luminance frames, as in the reference. The arcs follow the reference's
layout: :mod:`.ingest`, :mod:`.segment_cmds`, :mod:`.db_cmds`, with the
shared helpers in :mod:`.common`.
"""

from vit_research_tpu_torch.cli.parser import main  # noqa: F401

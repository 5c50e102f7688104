from vit_research_tpu_torch.retrieval.retrievers import (  # noqa: F401
    FrameRetriever,
    RattChunkRetriever,
)

"""``python -m vit_research_tpu_torch.cli`` entry point."""

from vit_research_tpu_torch.cli import main

if __name__ == "__main__":
    main()

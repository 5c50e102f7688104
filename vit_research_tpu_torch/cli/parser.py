"""Top-level parser: wires every command arc's ``register`` into one
program and dispatches; ``VRT_PROFILE=1`` prints the span report
(utils/profiling.py) at exit."""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    from vit_research_tpu_torch.cli import (db_cmds, eval_cmds, ingest,
                                            segment_cmds, serve_cmds,
                                            train_cmds)

    p = argparse.ArgumentParser(prog="vit_research_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ingest.register(sub)
    segment_cmds.register(sub)
    db_cmds.register(sub)
    train_cmds.register(sub)
    eval_cmds.register(sub)
    serve_cmds.register(sub)
    return p


def main(argv=None):
    from vit_research_tpu_torch.utils.profiling import print_global_report

    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    finally:
        print_global_report()

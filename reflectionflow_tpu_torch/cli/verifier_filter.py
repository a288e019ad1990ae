"""Post-hoc NFE filter CLI of the PyTorch port (the GenEval scaling-curve
points).

Usage, as the JAX package's `reflectionflow_tpu.cli.verifier_filter`: reads
a prior run's candidate images via --imgpath and writes nfe{K}/ selections to
--output_dir. It scores images only, so it builds no pipeline; --device is
checked all the same (cuda unless --device cpu, no fallback).
"""

from __future__ import annotations

from ..search.nfe_filter import DEFAULT_NFES, run_nfe_filter
from ..verifiers.base import RankingRule
from .common import build_parser, build_verifier, load_config, load_prompts, resolve_device


def main(argv=None):
    parser = build_parser(__doc__)
    parser.add_argument("--images_subdir", type=str, default="midimg")
    parser.add_argument("--nfes", type=int, nargs="+", default=list(DEFAULT_NFES))
    args = parser.parse_args(argv)
    resolve_device(args.device)
    cfg = load_config(args)
    prompts = load_prompts(args)
    verifier = build_verifier(cfg, device=args.device)
    rule = RankingRule(
        kind=verifier.output_kind,
        choice_of_metric=cfg.verifier_args.choice_of_metric,
    )
    sel = run_nfe_filter(
        verifier, rule, args.imgpath, cfg.output_dir, prompts,
        nfes=tuple(args.nfes), images_subdir=args.images_subdir,
        start_index=args.start_index,
    )
    for k, paths in sel.items():
        print(f"nfe{k}: {len(paths)} selections")


if __name__ == "__main__":
    main()

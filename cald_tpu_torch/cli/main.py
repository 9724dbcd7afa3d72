"""Entry point: ``python -m cald_tpu_torch.cli.main --dataset ... --strategy ...``.

Runs on the card; ``--device cpu`` asks for the CPU. Without CUDA and without
``--device cpu`` it exits non-zero with a message: there is no silent CPU run.
"""

from __future__ import annotations

import json
import sys

import torch

from cald_tpu_torch.cli.config import build_config_from_args
from cald_tpu_torch.cli.driver import al_loop


def main(argv=None):
    cfg = build_config_from_args(argv)
    if torch.device(cfg.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("cald_tpu_torch: CUDA is not available; pass --device cpu to run on the CPU")
    print(cfg)
    history = al_loop(cfg)
    print(json.dumps(
        [{k: (v if not isinstance(v, dict)
              else {kk: vv for kk, vv in v.items() if not isinstance(vv, dict)})
          for k, v in h.items()} for h in history],
        default=float, indent=1))
    return history


if __name__ == "__main__":
    main(sys.argv[1:])

"""Structured AL configuration + the reference-compatible argparse front end
(copy of ``cald_tpu/cli/config.py``, plus ``--device``).

Flag names/defaults follow cald_train.py:466-530; per-dataset init/budget
defaults follow cald_train.py:298-306 (and random_train.py:111-115 for the
random strategy's VOC sizes). The port runs on the card (``--device cuda``)
unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class ALConfig:
    # data
    dataset: str = "voc2007"            # voc2007 | voc2012 | coco
    data_path: str = "/data/VOCdevkit"
    # model
    model: str = "faster"               # faster | retina | faster_mobilenet | retina_mobilenet
    norm: str = "frozen"
    tiny: bool = False                  # miniature backbone (tests/smoke)
    # torchvision ImageNet checkpoint (.pth/.npz) for the backbone — the analog
    # of the reference's pretrained_backbone=True (frcnn_la.py:283)
    pretrained_backbone: str = ""
    # strategy
    strategy: str = "cald"              # cald|random|ll4al|vaal|ssm|ltc|lsc
    augs: str = "FCDR"
    bp: float = 1.3
    mr: float = 1.2
    uniform: bool = False
    no_mutual: bool = False
    ll_weight: float = 0.5              # ll_train.py --ll-weight
    task_epochs: int = 15               # ll_train.py --task_epochs (detach after)
    # AL schedule (None -> per-dataset reference defaults)
    cycles: int = 7
    init_num: int | None = None
    budget_num: int | None = None
    pool_cap: int | None = None         # COCO subsamples pool to 10000
    # optimization (cald_train.py:489-508)
    epochs: int = 20
    batch_size: int = 4
    lr: float = 0.0025
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_steps: tuple = (16, 19)
    lr_gamma: float = 0.1
    warmup_iters: int = 1000
    aspect_ratio_group_factor: int = 3
    # scoring
    score_batch_size: int = 16
    # RPN candidate counts for the pool-scoring model only (training/eval
    # always keep the reference 1000/1000). 0 = reference-faithful scoring.
    # post None = AUTO → 0 for every model since round 5: with the flm RoI
    # kernel the RoI stage no longer scales with proposal count, so the
    # round-4 post-768 trim buys only +2.8% (PERF.md) and the default is
    # reference-exact. 768 remains a floor-validated opt-in (4-seed sweep,
    # EXPERIMENTS.md: selection shift at the faithful path's own aug-re-roll
    # noise floor); deeper trims (512, 400/256) measured BELOW the floor
    # only. --score-rpn-post-nms 0 restores faithful scoring exactly.
    score_rpn_pre_nms: int = 0
    score_rpn_post_nms: int | None = None
    # Opt-in: detect shrink-resize augs on a smaller canvas slice (~10% less
    # scoring compute); slightly shifts scores with trained norm biases
    # (EXPERIMENTS.md deviation study).
    score_shrink_slice: bool = False
    # infra
    workers: int = 8
    seed: int = 0
    print_freq: int = 20
    output_dir: str = ""
    first_checkpoint_path: str = ""     # --skip reuse (cald_train.py:349-356)
    skip: bool = False
    # resume a killed AL run from a per-cycle checkpoint directory (written to
    # output_dir/cycle_k): restores pool + model/opt + strategy carry-state and
    # continues with cycle k's selection — bit-identical to an uninterrupted
    # run. Capability the reference lacks (its --skip loses the split, SURVEY §5).
    resume: str = ""
    # Capture a torch.profiler chrome trace of the FIRST cycle into this
    # directory: the device's activity (on the CPU its operators) and the
    # program's spans (``cald_tpu_torch.utils.spans``) as a row of their own.
    profile_dir: str = ""
    eval_every_cycle: bool = True
    classwise: bool = False
    max_boxes: int = 64
    # canvas overrides (None -> derived from dataset min/max sizes)
    min_size: int | None = None
    max_size: int | None = None
    # torch device of the run: "cuda" (the default) or "cpu"
    device: str = "cuda"

    def resolve(self) -> "ALConfig":
        """Fill dataset-dependent defaults (cald_train.py:298-306,338-347)."""
        c = dataclasses.replace(self)
        is_coco = "coco" in c.dataset
        if c.min_size is None:
            c.min_size = 800 if is_coco else 600
        if c.max_size is None:
            c.max_size = 1333 if is_coco else 1000
        if c.init_num is None:
            if is_coco:
                c.init_num = 5000
            elif c.strategy == "random":
                c.init_num = 1000                 # random_train.py:111-115
            elif "retina" in c.model:
                c.init_num = 1000
            else:
                c.init_num = 500
        if c.budget_num is None:
            if is_coco:
                c.budget_num = 1000
            elif c.strategy == "random":
                c.budget_num = 1000
            else:
                c.budget_num = 500
        if c.pool_cap is None:
            c.pool_cap = 10000 if is_coco else 0   # 0 = whole pool
        if c.score_rpn_post_nms is None:
            # Reference-faithful counts are the default again (round 5): with
            # the full-level-matmul RoI kernel the RoI stage no longer scales
            # with proposal count, so the round-4 floor-gated post-768 trim
            # buys only +2.8% (48.37 vs 47.04 img/s/chip, PERF.md) — not
            # worth any deviation. --score-rpn-post-nms 768 restores the
            # round-4 trimmed default (still at the noise floor, 4 seeds).
            c.score_rpn_post_nms = 0
        return c

    @property
    def num_classes(self) -> int:
        return 81 if "coco" in self.dataset else 21

    @property
    def eval_kind(self) -> str:
        return "coco" if "coco" in self.dataset else "voc"


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="cald_tpu_torch active-learning loop")
    p.add_argument("--dataset", default="voc2007")
    p.add_argument("--data-path", default="/data/VOCdevkit")
    p.add_argument("--model", default="faster")
    p.add_argument("--strategy", default="cald",
                   choices=["cald", "random", "ll4al", "vaal", "ssm", "ltc", "lsc"])
    p.add_argument("--augs", default="FCDR")
    p.add_argument("-bp", "--base-point", dest="bp", default=1.3, type=float)
    p.add_argument("-mr", "--mutual-range", dest="mr", default=1.2, type=float)
    p.add_argument("--uniform", action="store_true")
    p.add_argument("--no-mutual", dest="no_mutual", action="store_true")
    p.add_argument("--ll-weight", dest="ll_weight", default=0.5, type=float)
    p.add_argument("--task-epochs", dest="task_epochs", default=15, type=int)
    p.add_argument("--cycles", default=7, type=int)
    p.add_argument("--init-num", dest="init_num", default=None, type=int)
    p.add_argument("--budget-num", dest="budget_num", default=None, type=int)
    p.add_argument("--pool-cap", dest="pool_cap", default=None, type=int)
    p.add_argument("--epochs", default=20, type=int)
    p.add_argument("-b", "--batch-size", dest="batch_size", default=4, type=int)
    p.add_argument("--lr", default=0.0025, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--wd", "--weight-decay", dest="weight_decay", default=1e-4,
                   type=float)
    p.add_argument("--lr-steps", dest="lr_steps", default=[16, 19], nargs="+",
                   type=int)
    p.add_argument("--lr-gamma", dest="lr_gamma", default=0.1, type=float)
    p.add_argument("--aspect-ratio-group-factor", dest="aspect_ratio_group_factor",
                   default=3, type=int)
    p.add_argument("--score-batch-size", dest="score_batch_size", default=16,
                   type=int)
    p.add_argument("--score-rpn-pre-nms", dest="score_rpn_pre_nms", default=0,
                   type=int, help="RPN pre-NMS top-n for pool scoring; 0 "
                                  "(default) = reference-faithful; e.g. 400 "
                                  "trades selection fidelity for speed "
                                  "(EXPERIMENTS.md deviation study)")
    p.add_argument("--score-rpn-post-nms", dest="score_rpn_post_nms",
                   default=None, type=int,
                   help="RPN post-NMS proposals for pool scoring. Default "
                        "(unset) = 0 = reference-faithful (round 5: the flm "
                        "RoI kernel makes trims ~moot, PERF.md). 768 = "
                        "floor-validated opt-in (+2.8%; EXPERIMENTS.md "
                        "4-seed sweep); 256 = deeper opt-in (below floor)")
    p.add_argument("--score-shrink-slice", dest="score_shrink_slice",
                   action="store_true",
                   help="detect shrink-resize augs on a sliced canvas "
                        "(fast opt-in; see EXPERIMENTS.md)")
    p.add_argument("-j", "--workers", dest="workers", default=8, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--print-freq", dest="print_freq", default=20, type=int)
    p.add_argument("--output-dir", dest="output_dir", default="")
    p.add_argument("--first-checkpoint-path", dest="first_checkpoint_path",
                   default="")
    p.add_argument("--skip", action="store_true")
    p.add_argument("--resume", default="", metavar="CKPT_DIR",
                   help="resume from a per-cycle checkpoint (output_dir/"
                        "cycle_k): restores pool+model+strategy state and "
                        "continues from that cycle's selection")
    p.add_argument("--profile-dir", dest="profile_dir", default="",
                   metavar="DIR",
                   help="capture a torch.profiler chrome trace of the first "
                        "cycle into DIR")
    p.add_argument("--classwise", action="store_true",
                   help="per-class AP table in COCO eval (engine.py:221-254)")
    p.add_argument("--no-eval", dest="eval_every_cycle", action="store_false")
    p.add_argument("--tiny", action="store_true",
                   help="miniature backbone for smoke tests")
    p.add_argument("--pretrained-backbone", dest="pretrained_backbone",
                   default="", metavar="PATH",
                   help="torchvision ImageNet checkpoint (.pth or .npz) to "
                        "load into the backbone each cycle (reference "
                        "pretrained_backbone=True)")
    p.add_argument("--norm", default="frozen", choices=["frozen", "group"])
    p.add_argument("--min-size", dest="min_size", default=None, type=int)
    p.add_argument("--max-size", dest="max_size", default=None, type=int)
    p.add_argument("--max-boxes", dest="max_boxes", default=64, type=int)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def build_config_from_args(argv=None) -> ALConfig:
    args = make_parser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(ALConfig)}
    kwargs = {k: v for k, v in vars(args).items() if k in fields}
    kwargs["lr_steps"] = tuple(kwargs.get("lr_steps", (16, 19)))
    return ALConfig(**kwargs).resolve()

"""Active-learning strategies (port of ``cald_tpu.strategies``)."""

from cald_tpu_torch.strategies.cald import (  # noqa: F401
    CALDConfig, cald_select, labeled_class_counts, make_cald_score_fn, score_pool,
)
from cald_tpu_torch.strategies.ll4al import (  # noqa: F401
    ll_scores, ll_select, make_ll_score_fn, make_ll_train_step,
)
from cald_tpu_torch.strategies.lsc import NOISE_STDS, lsc_scores, make_lsc_score_fn  # noqa: F401
from cald_tpu_torch.strategies.ltc import ltc_scores, make_ltc_score_fn, run_ltc  # noqa: F401
from cald_tpu_torch.strategies.random_strategy import random_select  # noqa: F401
from cald_tpu_torch.strategies.ssm import CrossValidator, SSMConfig, ssm_select  # noqa: F401
from cald_tpu_torch.strategies.vaal import VAALTrainer, resize_for_vaal, vaal_select  # noqa: F401

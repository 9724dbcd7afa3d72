"""Selection experiments of the port (counterparts of the JAX package's
``experiments/`` scripts), each run as ``python -m
cald_tpu_torch.experiments.<name>`` on the card, or with ``--device cpu``:

* ``scoring_deviation``: how far scoring variants (other RPN counts, the
  shrink slice, the window RoIAlign, float32 numerics, re-rolled
  augmentations) move CALD's scores and its two-stage selection;
* ``consistency_separation``: whether a trained detector's consistency
  ranks hard images above easy ones.
"""

"""What the timed path produced for one sampled batch, kept for the check.

While armed, ``Capture`` wraps the detector's ``detect`` and hooks its
pyramid (``fpn``) and its heads (``rpn_head``/``box_predictor``, or
RetinaNet's ``head``), and keeps a copy of every detect call's input and
outputs, every image slot of the batch. Copies are device-to-device and
need no index from the host, so capturing adds no synchronisation. The
program and the reference's control share module names, so one capture
serves both.
"""

from __future__ import annotations

import dataclasses

import torch


def _copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone()


class Capture:
    def __init__(self, model):
        self.model = model
        self.calls: list[dict] = []
        self._handles = []
        self._detect = None

    def arm(self) -> None:
        """Keep every detect call's input and outputs until ``disarm``."""
        model, calls = self.model, self.calls

        def cur():
            return calls[-1]

        detect = model.detect

        def wrapped(images, valid_hw):
            calls.append({"images": _copy(images), "valid_hw": _copy(valid_hw),
                          "b": images.shape[0]})
            dets = detect(images, valid_hw)
            cur()["dets"] = dets.map(_copy)
            return dets

        def on_fpn(mod, args, out):
            cur()["pyramid"] = [_copy(f) for f in out]

        def on_rpn(mod, args, out):
            cur()["rpn"] = tuple(_copy(t) for t in out)

        def on_head(mod, args, out):
            cur()["head"] = tuple(_copy(t) for t in out)

        def on_predictor(mod, args, out):
            # (call_b * n, ...) -> (call_b, n, ...)
            cur()["box"] = tuple(_copy(t.reshape(cur()["b"], -1, *t.shape[1:])) for t in out)

        self._detect = detect
        model.detect = wrapped
        hooks = [(model.fpn, on_fpn)]
        if hasattr(model, "rpn_head"):
            hooks += [(model.rpn_head, on_rpn), (model.box_predictor, on_predictor)]
        else:
            hooks += [(model.head, on_head)]
        for mod, fn in hooks:
            self._handles.append(mod.register_forward_hook(fn))

    def disarm(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles.clear()
        if self._detect is not None:
            del self.model.detect          # the class's method again
            self._detect = None


@dataclasses.dataclass
class SampledBatch:
    """One sampled score batch as the timed path saw it: the batch's image
    paths, the augmentation generator's state before the call, the canvas
    and the answers of every slot, and the detect calls' captures."""

    paths: list
    draw_state: torch.Tensor
    images: torch.Tensor
    valid_hw: torch.Tensor
    consistency: torch.Tensor
    cls_corrs: torch.Tensor
    calls: list

    def nbytes(self) -> int:
        def size(x):
            if isinstance(x, torch.Tensor):
                return x.numel() * x.element_size()
            if isinstance(x, dict):
                return sum(size(v) for v in x.values())
            if isinstance(x, (list, tuple)):
                return sum(size(v) for v in x)
            if dataclasses.is_dataclass(x):
                return sum(size(getattr(x, f.name)) for f in dataclasses.fields(x))
            return 0
        return size([self.images, self.valid_hw, self.consistency, self.cls_corrs, self.calls])

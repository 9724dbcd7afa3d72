"""Host utilities (port of ``cald_tpu.utils``): detection visualisation."""

from cald_tpu_torch.utils.viz import draw_detections, save_detection_image

__all__ = ["draw_detections", "save_detection_image"]

"""The operation counts of backbones other than ResNet, one file each, found
by the backbone's name (``counting.backbone_counts``)."""

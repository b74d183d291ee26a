"""Frozen-feature evaluation of the DINOv3 backbones."""

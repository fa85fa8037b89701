"""Special item tokens (reference rectools/models/nn/transformers/constants.py:15-16)."""

PADDING_VALUE = "PAD"
MASKING_VALUE = "MASK"

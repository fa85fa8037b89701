"""Retrieval tools: ANN-style recommenders over the port's top-k engine
(port of rectools_tpu/tools).

The other modules of this folder are scripts that check kernels on the card
(``python3 rectools_tpu_torch/tools/<name>.py``); this package does not
import them.
"""

from .ann import ItemToItemAnnRecommender, UserToItemAnnRecommender

__all__ = ["ItemToItemAnnRecommender", "UserToItemAnnRecommender"]

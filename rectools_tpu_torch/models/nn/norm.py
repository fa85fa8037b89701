"""FusedLayerNorm — LayerNorm backed by the CUDA kernel (ops/layer_norm.py).

Parameter names match flax ``nn.LayerNorm`` ("scale", "bias") so converted
parameter trees load by name. Every CUDA input takes the kernel (the JAX
package's shape dispatch weighed an XLA fusion barrier that has no
counterpart here); CPU inputs take the plain twin.
"""

import typing as tp

import torch
from torch import nn

from ...ops.layer_norm import layer_norm


class FusedLayerNorm(nn.Module):
    def __init__(self, n_factors: int, epsilon: float = 1e-6, device: tp.Optional[torch.device] = None) -> None:
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(n_factors, device=device))
        self.bias = nn.Parameter(torch.zeros(n_factors, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        return layer_norm(x.reshape(-1, d), self.scale, self.bias, self.epsilon).reshape(x.shape)

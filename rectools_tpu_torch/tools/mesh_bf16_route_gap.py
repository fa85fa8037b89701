#!/usr/bin/env python3
"""Where the bf16 mesh loss's gradients part from the bf16 loss without a
mesh, on one NVIDIA GPU (the CPU with ``--cpu`` and a small shape).

Run from the repository root: ``python3
rectools_tpu_torch/tools/mesh_bf16_route_gap.py`` (under a minute). On bf16
towers at the KION training shape (51,200 session rows of a batch of 512 x
100, a 15,872-row catalog, d = 128, labels drawn from a Zipf(1.2) law as the
smoke frame's items, 10% padding), it takes the gradients of the full-catalog
softmax loss two ways: the route without a mesh (kernels 6 and 7 in bf16:
the label term inside the probability tile, one rounding of (P - D)) and
the mesh route at ``mesh_shape=(1, 1)`` (kernels 8 and 9 in bf16 for the lse,
then ``_ce_from_lse``'s label logit through autograd: the lse's gradient and
the label term's each rounded to bf16 before they are added, as the JAX
package's mesh route does). Both are held against the f32 loss of the same
bf16 values (kernels 6 and 7 in f32). It prints, for ds and for di, the
largest error relative to the reference's largest entry, and for di the
error of the item rows by how often they are labels (the ten most frequent,
the rest). The first line names the card and its power limit; the last is
one JSON object.
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main() -> int:
    import numpy as np
    import torch

    from rectools_tpu_torch.models.nn.transformers.losses import _ce_from_lse, fused_softmax_loss
    from rectools_tpu_torch.ops import softmax_lse
    from rectools_tpu_torch.parallel import make_mesh

    cpu = "--cpu" in sys.argv
    if not cpu and not torch.cuda.is_available():
        print("mesh_bf16_route_gap: needs an NVIDIA GPU (or --cpu)", file=sys.stderr)
        return 2
    if cpu:
        dev, (b, l, n, d) = torch.device("cpu"), (8, 20, 3000, 32)
        print("cpu")
    else:
        dev, (b, l, n, d) = torch.device("cuda"), (512, 100, 15872, 128)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    rng = np.random.default_rng(22)
    s = torch.from_numpy(rng.normal(size=(b, l, d)).astype(np.float32)).to(dev).to(torch.bfloat16)
    items = torch.from_numpy((0.1 * rng.normal(size=(n, d))).astype(np.float32)).to(dev).to(torch.bfloat16)
    labels = 1 + (rng.zipf(1.2, size=(b, l)) % (n - 1))
    labels[rng.random((b, l)) < 0.1] = 0  # padding
    y = torch.from_numpy(labels).to(dev)
    w = (y != 0).float()
    mesh = make_mesh(1, 1)

    def grads(route: str, dtype: torch.dtype):
        sg = s.detach().to(dtype).requires_grad_()
        ig = items.detach().to(dtype).requires_grad_()
        if route == "mesh":
            lse = softmax_lse.sharded_streaming_lse(sg.reshape(-1, d), ig, mesh, "model", data_axis="data")
            loss = _ce_from_lse(sg, ig, y, w, lse.reshape(b, l))
        else:
            loss = fused_softmax_loss(sg, ig, y, w)
        loss.backward()
        return sg.grad.float().reshape(-1, d), ig.grad.float()

    ref_ds, ref_di = grads("plain", torch.float32)
    counts = torch.bincount(y.reshape(-1), minlength=n)
    counts[0] = 0
    top = torch.argsort(counts, descending=True)[:10]
    rest = torch.ones(n, dtype=torch.bool, device=dev)
    rest[top] = False
    rest[0] = False
    scale_ds, scale_di = ref_ds.abs().max(), ref_di.abs().max()
    out = {"shape": [b * l, n, d], "top10_label_counts": counts[top].tolist()}
    for route in ("plain", "mesh"):
        ds, di = grads(route, torch.bfloat16)
        err_di = (di - ref_di).abs().max(dim=1).values / scale_di
        out[route] = {
            "ds": ((ds - ref_ds).abs().max() / scale_ds).item(),
            "di": err_di.max().item(),
            "di_top10_labels": err_di[top].max().item(),
            "di_other_rows": err_di[rest].max().item(),
        }
        print(route, out[route], flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the four-rank (2, 2) mesh fit parts from the single-process fit, on
one NVIDIA GPU: ``chip_smoke.py``'s ``mesh fit 4`` phase (the same ranks,
frame, model and seed), reported by parameter instead of checked.

Run from the repository root: ``python3
rectools_tpu_torch/tools/mesh_fit_diff.py [CHECKOUT]`` (about a minute and a
half). CHECKOUT (default: this checkout) is the tree whose ``chip_smoke.py``
and kernels run, so an edited copy of the sources can be compared with the
tree as it is. For every parameter it prints the largest absolute difference
and the number of entries above 5e-5 and 2e-5; for the item table
(``ids_emb``), the 12 largest differences with their row, column, both
values, the item's external id and its number of interactions in the frame.
"""

import sys
import time
from pathlib import Path


def main() -> int:
    checkout = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(checkout))
    import numpy as np
    import pandas as pd
    import torch

    import chip_smoke as cs
    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset
    from rectools_tpu_torch.parallel.launch import run_ranks

    if not torch.cuda.is_available():
        print("mesh_fit_diff: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    ranks = run_ranks(cs.mesh_rank_worker, 4, (str(checkout), "cuda"), timeout_s=cs.MESH_RANK_TIMEOUT_S,
                      backend="gloo", threads=2)
    frame = cs.kion_frame(np, pd, Columns, cs.RAGGED_N - 1)
    dataset = Dataset.construct(frame)
    single = cs._mesh_model("cuda", None, 1)
    single.fit(dataset)
    params, mesh = single.training_module.get_state()["params"], ranks[0]["params"]
    counts = frame[Columns.Item].value_counts()
    print(f"{checkout}: {time.time() - t0:.0f} s")
    for name, value in params.items():
        diff = (mesh[name] - value).abs()
        print(f"  {name:60s} max {diff.max().item():.3e}  >5e-5: {(diff > 5e-5).sum().item():6d}  "
              f">2e-5: {(diff > 2e-5).sum().item():6d}  numel {diff.numel()}")
        if not name.endswith("ids_emb.weight"):
            continue
        top = torch.topk(diff.flatten(), 12)
        for v, i in zip(top.values.tolist(), top.indices.tolist()):
            row, col = divmod(i, diff.shape[1])
            item = dataset.item_id_map.convert_to_external(np.array([row]))[0]
            print(f"    row {row} col {col} diff {v:.3e} mesh {mesh[name][row, col].item():+.6f} single "
                  f"{value[row, col].item():+.6f} item {item} interactions {int(counts.get(item, 0))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

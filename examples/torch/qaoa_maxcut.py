"""QAOA MaxCut training with quest_tpu_torch.

The port's counterpart of examples/qaoa_maxcut.py.  Maximises the
expected cut of a random weighted graph with a p-layer QAOA ansatz: the
diagonal cost phases, RX mixers and the cut expectation are plain
PyTorch ops (quest_tpu_torch.models.qaoa), differentiated by
torch.autograd and stepped by torch.optim.Adam.

Run:  python examples/torch/qaoa_maxcut.py      (the CUDA card)
      QT_EXAMPLES_CPU=1 python examples/torch/qaoa_maxcut.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch

from quest_tpu_torch.models import qaoa as qaoa_mod

# the CPU only when asked for; otherwise the card, or an error without one
DEVICE = "cpu" if os.environ.get("QT_EXAMPLES_CPU") == "1" else None


def main():
    n = int(os.environ.get("QT_QAOA_QUBITS", "12"))
    edges = qaoa_mod.random_graph(n, 2 * n, seed=1)
    model = qaoa_mod.QAOA(n, edges, depth=3, device=DEVICE)

    params = model.init_params(torch.Generator().manual_seed(0))
    params.requires_grad_(True)
    opt = torch.optim.Adam([params], lr=5e-2)
    step = model.make_train_step(opt)

    total_w = sum(w for _, _, w in edges)
    print(f"QAOA MaxCut: {n} qubits, {len(edges)} edges, total weight {total_w:.2f}")
    for i in range(60):
        cut = step(params)
        if i % 10 == 0 or i == 59:
            print(f"  step {i:3d}  expected cut = {float(cut):.4f}")
    print("done")


if __name__ == "__main__":
    main()

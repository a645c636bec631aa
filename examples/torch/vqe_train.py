"""VQE training with quest_tpu_torch: gradient descent on a PauliHamil
energy.

The port's counterpart of examples/vqe_train.py.  The reference library
can *evaluate* <psi|H|psi> (calcExpecPauliHamil, QuEST.h:4285) but has no
autodiff and no optimizer; here the ansatz and the energy are plain
PyTorch ops on the state (quest_tpu_torch.models.vqe), differentiated by
torch.autograd and stepped by torch.optim.Adam.

Run:  python examples/torch/vqe_train.py      (the CUDA card)
      QT_EXAMPLES_CPU=1 python examples/torch/vqe_train.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch

from quest_tpu_torch.models import vqe as vqe_mod

# the CPU only when asked for; otherwise the card, or an error without one
DEVICE = "cpu" if os.environ.get("QT_EXAMPLES_CPU") == "1" else None


def main():
    num_qubits = int(os.environ.get("QT_VQE_QUBITS", "10"))
    depth, num_terms, steps = 3, 6, 60

    codes, coeffs = vqe_mod.random_hamiltonian(num_qubits, num_terms, seed=11)
    model = vqe_mod.VQE(num_qubits, depth, codes, coeffs, mesh=None,
                        device=DEVICE)

    params = model.init_params(torch.Generator().manual_seed(0))
    params.requires_grad_(True)
    optimizer = torch.optim.Adam([params], lr=5e-2)
    step = model.make_train_step(optimizer)

    print(f"VQE: {num_qubits} qubits, depth {depth}, {num_terms} Pauli terms")
    for i in range(steps):
        energy = step(params)
        if i % 10 == 0 or i == steps - 1:
            print(f"  step {i:3d}  energy = {float(energy):+.6f}")

    print("done; final energy", float(energy))


if __name__ == "__main__":
    main()

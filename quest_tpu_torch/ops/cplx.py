"""SoA (structure-of-arrays) complex arithmetic.

The amplitude state is a real tensor of shape ``(2, ...)``: channel 0 is
the real part, channel 1 the imaginary part.  This is the reference's
``ComplexArray`` layout (QuEST.h:77) and the JAX package's layout, kept so
that both packages exchange states and plans as the same arrays.  The
hand-written kernels read the two planes directly; plain PyTorch code may
view a state as a complex tensor for the length of one operation
(``to_complex`` / ``from_complex``).
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side conversions (NumPy)
# ---------------------------------------------------------------------------


def soa(arr, dtype=None) -> np.ndarray:
    """NumPy complex (or real) array -> stacked (2, *shape) real array."""
    a = np.asarray(arr)
    out = np.stack([a.real.astype(np.float64), a.imag.astype(np.float64)])
    if dtype is not None:
        out = out.astype(dtype)
    return out


def unsoa(arr) -> np.ndarray:
    """Stacked (2, *shape) -> NumPy complex."""
    a = np.asarray(arr)
    return a[0] + 1j * a[1]


# ---------------------------------------------------------------------------
# Tensor SoA arithmetic (stacked leading channel axis)
# ---------------------------------------------------------------------------


def to_complex(s: torch.Tensor) -> torch.Tensor:
    """(2, ...) real tensor -> complex tensor of the trailing shape."""
    return torch.complex(s[0], s[1])


def from_complex(z: torch.Tensor) -> torch.Tensor:
    """Complex tensor -> stacked (2, ...) real tensor."""
    return torch.stack([z.real, z.imag])


def cmul(s: torch.Tensor, f_re, f_im) -> torch.Tensor:
    """(2, ...) state times a broadcastable complex factor (f_re, f_im)."""
    return torch.stack([s[0] * f_re - s[1] * f_im, s[0] * f_im + s[1] * f_re])


def cmul_s(a, b):
    """Elementwise product of two stacked arrays."""
    return torch.stack([a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]])


def conj(s):
    if isinstance(s, np.ndarray):
        return np.stack([s[0], -s[1]])
    return torch.stack([s[0], -s[1]])


def abs2(s: torch.Tensor) -> torch.Tensor:
    """|z|^2, shape = trailing dims."""
    return s[0] * s[0] + s[1] * s[1]


def scale(s, f_re):
    """Real scaling (applies to both channels)."""
    return s * f_re


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a|b> = sum conj(a)*b over all trailing dims -> stacked (2,)."""
    re = torch.sum(a[0] * b[0] + a[1] * b[1])
    im = torch.sum(a[0] * b[1] - a[1] * b[0])
    return torch.stack([re, im])

"""Carry state from the JAX package into the port, as plain data.

The caller turns the reference objects into numpy arrays and host ints
(`np.asarray` on each array); nothing here sees a JAX type.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto.curve import G1
from .device import resolve
from .plonk.circuit import Circuit, ConstraintSystem
from .plonk.keygen import ProvingKey, VerifyingKey
from .poly.kzg import Srs

PK_ARRAYS = (
    "fixed_evals", "fixed_coeffs", "sigma_evals", "sigma_coeffs", "fixed_ext",
    "sigma_ext", "l0_ext", "llast_ext", "lactive_ext", "x_ext", "t_inv_ext",
)


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.uint8, copy=True), device=device)


def srs_from_numpy(k: int, g1_x, g1_y, g1_z, g2: tuple, s_g2: tuple,
                   device=None) -> Srs:
    """An Srs from the reference SRS's G1 coordinate arrays ((n, 32) u8
    Montgomery Fq digits) and its G2 points (host ints)."""
    dev = resolve(device)
    return Srs(k=k, g1_powers=G1(_t(g1_x, dev), _t(g1_y, dev), _t(g1_z, dev)),
               g2=g2, s_g2=s_g2)


def proving_key_from_numpy(circuit: Circuit, k: int, arrays: dict,
                           vk_points: dict, delta_pows: list,
                           device=None) -> ProvingKey:
    """The port's ProvingKey from a reference ProvingKey given as data.

    `arrays` maps each name of PK_ARRAYS to a numpy u8 array; `vk_points`
    holds "fixed_commitments", "sigma_commitments" (affine int pairs),
    "g2" and "s_g2"; `delta_pows` are host ints.  The constraint system is
    the port's own, from configuring `circuit`."""
    dev = resolve(device)
    cs = ConstraintSystem()
    circuit.configure(cs)
    t = {name: _t(arrays[name], dev) for name in PK_ARRAYS}
    k_ext = int(t["fixed_ext"].shape[-2]).bit_length() - 1
    vk = VerifyingKey(
        k=k, cs=cs,
        fixed_commitments=list(vk_points["fixed_commitments"]),
        sigma_commitments=list(vk_points["sigma_commitments"]),
        g2=vk_points["g2"], s_g2=vk_points["s_g2"],
    )
    return ProvingKey(vk=vk, k_ext=k_ext, delta_pows=[int(d) for d in delta_pows],
                      **t)

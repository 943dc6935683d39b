"""Shared helpers of the LM parity tests (``tests/test_torch_lm_*.py``):
carry a JAX config and params over to the port, and compare outputs.

Tolerances: fp32 compute on both sides within 1e-4 * max(1, max |ref|);
the configs' bf16 compute within 5e-2 * max(1, max |ref|), the bound of
the reference's own prefill-against-forward test (``tests/test_models.py``)
in the port's scale-relative form.  The element-wise form (rtol = atol =
5e-2) fails on zamba2's smoke config alone (23 of 32,768 logits, each near
0): its seven layers each differ from the reference by one bf16 ulp of a
residual stream that grows to about 8, where one ulp is 0.0625.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.interop import lm_params_from_arrays
from repro_torch.models.config import ModelConfig as PortConfig

TOL = 1e-4
BF16_TOL = 5e-2
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def port_cfg(jcfg) -> PortConfig:
    """The port's ModelConfig with ``jcfg``'s fields (dtypes mapped)."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for k in ("param_dtype", "compute_dtype"):
        kw[k] = _DTYPES[np.dtype(kw[k]).name]
    return PortConfig(**kw)


def with_dtype(jcfg, name: str):
    return dataclasses.replace(jcfg, compute_dtype=_JDTYPES[name])


def carry(jparams, jcfg):
    """The reference's params as the port's tree on the CPU."""
    tree = jax.tree.map(np.asarray, jparams)
    return lm_params_from_arrays(tree, port_cfg(jcfg), device="cpu")


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol=TOL) -> float:
    """Max |got - want| within ``tol * max(1, max |want|)``.  Entries of
    magnitude 1e29 and more are the head's -1e30 masks of padded vocab
    columns: they must be equal, and they stay out of the scale."""
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    real = np.abs(want) < 1e29
    assert np.array_equal(got[~real], want[~real]), "masked entries differ"
    got, want = got[real], want[real]
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, f"max |diff| {err} > {tol} * {scale}"
    return err


def close_bf16(got, want) -> float:
    return close(got, want, BF16_TOL)


def to_torch(tree):
    """A nested dict of JAX/numpy arrays as CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))

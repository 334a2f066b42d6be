"""Checkpoint / resume.

Text-format parity with the reference (Model::saveFacs/loadFacs,
model.cpp:11-188): factors written as whitespace text matrices named
``{prefix}_uFac_{signature}.mat`` / ``_iFac_``, signature =
``{nUsers}X{nItems}_{facDim}_{uReg}_{iReg}_{learnRate}``
(modelSignature, model.cpp:11-19); invalid sets as ``_invalUsers.txt`` /
``_invalItems.txt`` (main.cpp:113-117). A fast binary .npz path stores
the full state + training-loop progress for exact resume.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params
from matfac_tpu.data.io import read_factor_mat, write_factor_mat
from matfac_tpu.models.base import MFState


def model_signature(params: Params, n_users: int, n_items: int) -> str:
    """modelSignature analog (model.cpp:11-19)."""
    return (f"{n_users}X{n_items}_{params.fac_dim}_{params.u_reg}"
            f"_{params.i_reg}_{params.learn_rate}")


def fac_paths(prefix: str, sig: str) -> Tuple[str, str]:
    return (f"{prefix}_uFac_{sig}.mat", f"{prefix}_iFac_{sig}.mat")


def save_facs(state: MFState, prefix: str, sig: str) -> Tuple[str, str]:
    """saveFacs analog (model.cpp:89-101): text factor matrices."""
    up, ip = fac_paths(prefix, sig)
    write_factor_mat(np.asarray(state.u_fac), up)
    write_factor_mat(np.asarray(state.i_fac), ip)
    return up, ip


def load_facs(state: MFState, prefix: str, sig: str) -> Optional[MFState]:
    """loadFacs analog (model.cpp:104-128): existence-checked."""
    up, ip = fac_paths(prefix, sig)
    if not (os.path.exists(up) and os.path.exists(ip)):
        return None
    u = read_factor_mat(up, *state.u_fac.shape)
    i = read_factor_mat(ip, *state.i_fac.shape)
    return state._replace(u_fac=jnp.asarray(u), i_fac=jnp.asarray(i))


def bias_paths(prefix: str, sig: str) -> Tuple[str, str, str]:
    """Model::save's bias file names (model.cpp:43-57): note the global
    bias is ``{prefix}_{sig}_gBias`` (sig BEFORE the name, no ext)."""
    return (f"{prefix}_uBias_{sig}.vec", f"{prefix}_iBias_{sig}.vec",
            f"{prefix}_{sig}_gBias")


def save_full(state: MFState, prefix: str, sig: str) -> None:
    """Model::save analog (model.cpp:31-58): factors + uBias/iBias
    (one value per line, writeVector io.cpp:369-388) + global bias mu
    as a 1-element vector."""
    from matfac_tpu.data.io import write_vector
    save_facs(state, prefix, sig)
    ub, ib, gb = bias_paths(prefix, sig)
    write_vector(np.asarray(state.u_bias), ub)
    write_vector(np.asarray(state.i_bias), ib)
    write_vector(np.asarray([float(state.mu)]), gb)


def load_full(state: MFState, prefix: str, sig: str) -> Optional[MFState]:
    """Model::load analog (model.cpp:61-86): factors + biases + mu,
    existence-checked as a set (a factors-only checkpoint loads via
    load_facs instead)."""
    from matfac_tpu.data.io import read_vector
    st = load_facs(state, prefix, sig)
    if st is None:
        return None
    ub, ib, gb = bias_paths(prefix, sig)
    if not (os.path.exists(ub) and os.path.exists(ib)
            and os.path.exists(gb)):
        return None
    u_bias = read_vector(ub)
    i_bias = read_vector(ib)
    mu = read_vector(gb)[0]
    return st._replace(u_bias=jnp.asarray(u_bias, jnp.float32),
                       i_bias=jnp.asarray(i_bias, jnp.float32),
                       mu=jnp.asarray(mu, jnp.float32))


def save_invalid(prefix: str, invalid_users: np.ndarray,
                 invalid_items: np.ndarray) -> None:
    """main.cpp:1387-1393 analog: one id per line."""
    np.savetxt(prefix + "_invalUsers.txt",
               np.nonzero(invalid_users)[0], fmt="%d")
    np.savetxt(prefix + "_invalItems.txt",
               np.nonzero(invalid_items)[0], fmt="%d")


def load_invalid(prefix: str, n_users: int, n_items: int
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    up, ip = prefix + "_invalUsers.txt", prefix + "_invalItems.txt"
    if not (os.path.exists(up) and os.path.exists(ip)):
        return None
    u = np.zeros(n_users, bool)
    i = np.zeros(n_items, bool)
    u[np.loadtxt(up, dtype=np.int64, ndmin=1)] = True
    i[np.loadtxt(ip, dtype=np.int64, ndmin=1)] = True
    return u, i


def save_bin_facs(state: MFState, prefix: str, sig: str
                  ) -> Tuple[str, str]:
    """saveBinFacs analog (model.cpp:131-140): reference-bit-format
    ``{prefix}_uFac_{sig}.binmat`` raw float64 streams."""
    from matfac_tpu.data.io import write_factor_mat_bin
    up = f"{prefix}_uFac_{sig}.binmat"
    ip = f"{prefix}_iFac_{sig}.binmat"
    write_factor_mat_bin(np.asarray(state.u_fac), up)
    write_factor_mat_bin(np.asarray(state.i_fac), ip)
    return up, ip


def load_bin_facs(state: MFState, prefix: str, sig: str
                  ) -> Optional[MFState]:
    """loadBinFacs analog (model.cpp:143-159): existence-checked; reads
    binaries written by the reference (headerless f64 row-major)."""
    from matfac_tpu.data.io import read_factor_mat_bin
    up = f"{prefix}_uFac_{sig}.binmat"
    ip = f"{prefix}_iFac_{sig}.binmat"
    if not (os.path.exists(up) and os.path.exists(ip)):
        return None
    u = read_factor_mat_bin(up, *state.u_fac.shape)
    i = read_factor_mat_bin(ip, *state.i_fac.shape)
    return state._replace(u_fac=jnp.asarray(u), i_fac=jnp.asarray(i))


# ----------------------------------------------------------------------
# binary full-state checkpoints (resume)
# ----------------------------------------------------------------------

def save_state(path: str, state: MFState, **extra) -> None:
    np.savez(path,
             u_fac=np.asarray(state.u_fac), i_fac=np.asarray(state.i_fac),
             u_bias=np.asarray(state.u_bias),
             i_bias=np.asarray(state.i_bias), mu=np.asarray(state.mu),
             **extra)


def load_state(path: str) -> Tuple[MFState, dict]:
    z = np.load(path)
    state = MFState(jnp.asarray(z["u_fac"]), jnp.asarray(z["i_fac"]),
                    jnp.asarray(z["u_bias"]), jnp.asarray(z["i_bias"]),
                    jnp.asarray(z["mu"]))
    extra = {k: z[k] for k in z.files
             if k not in ("u_fac", "i_fac", "u_bias", "i_bias", "mu")}
    return state, extra


# ----------------------------------------------------------------------
# sharded checkpoints (orbax) — multi-host-safe save/restore of factor
# tables placed on a mesh (SURVEY.md §5 "checkpoint/resume": this
# build stores sharded tables + loop progress; the reference's text
# factors remain the interchange format)
# ----------------------------------------------------------------------

def _globalize_leaf(x):
    """Multi-host orbax can only serialize GLOBAL jax.Arrays; leaves
    that are process-local (e.g. replicated biases living as
    single-device arrays) are re-placed as globally-replicated arrays
    over an all-devices mesh (every process holds the same value)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    if jax.process_count() == 1:
        return x
    if hasattr(x, "is_fully_addressable") and not x.is_fully_addressable:
        return x   # already a global array (mesh-sharded state)
    mesh = Mesh(np.asarray(jax.devices()), ("all",))
    return jax.device_put(np.asarray(x),
                          NamedSharding(mesh, PartitionSpec()))


def save_sharded(path: str, state: MFState, **extra) -> None:
    import jax
    import orbax.checkpoint as ocp
    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    payload = {"state": jax.tree_util.tree_map(_globalize_leaf,
                                               state._asdict()),
               "extra": {k: np.asarray(v) for k, v in extra.items()}}
    ckptr.save(path, payload, force=True)
    ckptr.wait_until_finished()


def restore_sharded(path: str, like: MFState):
    """Restore with the shardings/dtypes of ``like`` (pass a sharded
    abstract or concrete state to bring tables up already-placed)."""
    import orbax.checkpoint as ocp
    path = os.path.abspath(path)
    import jax

    def replace(v, target):
        """Re-place a restored leaf WITHOUT cross-host transfers (the
        CPU backend refuses them): leaves already in the target
        sharding pass through; replicated global leaves re-place from
        the process-local full copy."""
        if not isinstance(v, jax.Array):
            return jax.device_put(v, target)
        if v.sharding == target:
            return v
        if v.is_fully_addressable:
            return jax.device_put(np.asarray(v), target)
        shard = v.addressable_shards[0]
        if shard.data.shape == v.shape:   # replicated: local copy full
            return jax.device_put(np.asarray(shard.data), target)
        raise ValueError(
            f"cannot re-place a cross-host-sharded leaf from "
            f"{v.sharding} to {target}; restore with a `like` state "
            "in the checkpoint's own sharding")

    ckptr = ocp.StandardCheckpointer()
    out = ckptr.restore(path)
    state = MFState(**{k: replace(v, getattr(like, k).sharding)
                       for k, v in out["state"].items()})
    return state, out.get("extra", {})

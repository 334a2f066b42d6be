"""Device mesh construction + factor-table sharding specs.

The reference's only parallelism is single-node OpenMP shared memory
(SURVEY.md §2 "Parallelism status"); there is nothing to port. This
module is the from-scratch multi-device scaling layer: a 1-2D
``jax.sharding.Mesh`` whose axes shard the *embedding-table heights*
(n_users / n_items) — the scale axes of this workload (SURVEY.md §5
"long-context" note). PP/TP-for-matmuls/SP/EP do not apply to MF; the
distributed decomposition is

  * "u" axis — row-shards uFac (the DP-like axis: rating batches are
    partitioned by user block so user rows stay local), and
  * "i" axis — row-shards iFac (the MP-like axis: item rows are fetched
    / reduced via collectives XLA inserts, or explicitly rotated by the
    DSGD solver in parallel.dsgd).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from matfac_tpu.models.base import MFState


def make_mesh(shape: Optional[Sequence[int]] = None,
              axes: Sequence[str] = ("u", "i"),
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None or len(shape) == 0:
        # default: all devices on the user axis
        shape = (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axes[: len(shape)]))


def shard_state(state: MFState, mesh: Mesh, u_axis: str = "u",
                i_axis: str = "i") -> MFState:
    """Place a model state onto the mesh: factors row-sharded, biases
    sharded along the same axes, mu replicated. A table whose height
    does not divide its axis is replicated instead (a jax.Array shards
    only evenly; e.g. ML-20M's 138,493 users over 4 devices)."""
    def axis_for(name: str, n: int):
        if name in mesh.axis_names and n % mesh.shape[name] == 0:
            return name
        return None

    ua = axis_for(u_axis, state.u_fac.shape[0])
    ia = axis_for(i_axis, state.i_fac.shape[0])
    put = lambda x, *spec: jax.device_put(  # noqa: E731
        x, NamedSharding(mesh, P(*spec)))
    return MFState(
        u_fac=put(state.u_fac, ua, None),
        i_fac=put(state.i_fac, ia, None),
        u_bias=put(state.u_bias, ua),
        i_bias=put(state.i_bias, ia),
        mu=put(state.mu),
    )


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m

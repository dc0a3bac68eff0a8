"""Hybrid-parallel topology (counterpart: paddle_tpu/distributed/
topology.py).

`CommunicateTopology` is the host-only N-D rank grid, copied.  The JAX
package's `build_mesh` returns a ``jax.sharding.Mesh`` of devices; torch
has no device-mesh object a rank could hold, so here it returns the
`CommunicateTopology` of those degrees over the axes ``("dp", "pp",
"sp", "mp")``, whose ``shape`` reads like the mesh's.

`HybridCommunicateGroup` is data-parallel only: its data-parallel group
is every rank of the default ``torch.distributed`` group (the world size,
1 without one), its getters answer from it, and a degree above 1 on
``mp``, ``pp``, ``sp`` or ``sharding`` raises NotImplementedError naming
what is still to come (tensor, pipeline, sequence and ZeRO parallelism:
ROADMAP.md Queue 1, item 2).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import parallel as _par

__all__ = ["AXIS_ORDER", "CommunicateTopology", "build_mesh",
           "HybridCommunicateGroup", "set_hybrid_communicate_group",
           "get_hybrid_communicate_group"]

AXIS_ORDER = ("dp", "pp", "sp", "mp")

_LATER = "ROADMAP.md Queue 1, item 2"


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world = int(np.prod(dims))

    @property
    def shape(self) -> dict:
        return dict(zip(self._parallel_names, self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self):
        return self._world

    def get_rank(self, **args):
        idx = [args[n] for n in self._parallel_names]
        return int(np.ravel_multi_index(idx, self._dims))

    def get_coord(self, rank):
        return tuple(int(i) for i in np.unravel_index(rank, self._dims))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r in range(self._world)
                if self.get_coord(r)[axis] == index]

    def get_comm_list(self, axis_name):
        """The rank groups along ``axis_name``."""
        axis = self._parallel_names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for flat in range(int(np.prod(other_dims)) if other_dims else 1):
            coords = list(np.unravel_index(flat, other_dims)) \
                if other_dims else []
            group = []
            for k in range(self._dims[axis]):
                full = coords[:axis] + [k] + coords[axis:]
                group.append(self.get_rank(
                    **dict(zip(self._parallel_names, full))))
            groups.append(group)
        return groups


def build_mesh(dp: int = 1, pp: int = 1, sp: int = 1, mp: int = 1,
               devices=None) -> CommunicateTopology:
    """The topology of these degrees over `AXIS_ORDER` (see the module
    docstring: no device-mesh object)."""
    return CommunicateTopology(AXIS_ORDER, (dp, pp, sp, mp))


def _refuse(**degrees):
    for name, d in degrees.items():
        if int(d) > 1:
            raise NotImplementedError(
                f"{name} degree {d}: the port's hybrid parallelism is "
                f"data-parallel only; {name} comes with {_LATER}")


class HybridCommunicateGroup:
    """The data-parallel group of this run and the topology's queries."""

    def __init__(self, topology: CommunicateTopology = None, mesh=None,
                 dp=None, pp=1, sp=1, mp=1, sharding=1):
        if topology is not None:
            degs = dict(zip(topology.get_hybrid_group_names(),
                            topology._dims))
            dp = degs.get("data", dp)
            pp, mp = degs.get("pipe", pp), degs.get("model", mp)
            sharding = degs.get("sharding", sharding)
        if mesh is not None:
            dp = mesh.shape.get("dp", dp)
            pp, sp = mesh.shape.get("pp", pp), mesh.shape.get("sp", sp)
            mp = mesh.shape.get("mp", mp)
        _refuse(mp=mp, pp=pp, sp=sp, sharding=sharding)
        world = _par.get_world_size()
        dp = world if dp is None else int(dp)
        if dp != world:
            raise ValueError(f"data-parallel degree {dp} must equal the "
                             f"world size {world} (one rank a process)")
        self._dp, self._pp, self._sp, self._mp = dp, 1, 1, 1
        self._sharding = 1
        self._topo = CommunicateTopology(("data", "pipe", "sharding",
                                          "model"), (dp, 1, 1, 1))
        self._mesh = build_mesh(dp=dp)
        self.global_rank = _par.get_rank()
        from .collective import Group

        self._dp_group = Group("dp", list(range(dp)), id=0, pg=None)

    @property
    def mesh(self) -> CommunicateTopology:
        return self._mesh

    def get_data_parallel_world_size(self):
        return self._dp

    def get_model_parallel_world_size(self):
        return self._mp

    def get_pipe_parallel_world_size(self):
        return self._pp

    def get_sharding_parallel_world_size(self):
        return self._dp

    def get_sequence_parallel_world_size(self):
        return self._sp

    def get_parallel_mode(self):
        return "data_parallel"

    def get_data_parallel_rank(self):
        return self.global_rank

    def get_model_parallel_rank(self):
        return 0

    def get_stage_id(self):
        return 0

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return 0

    def topology(self):
        return self._topo


_HCG: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: HybridCommunicateGroup):
    global _HCG
    _HCG = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _HCG

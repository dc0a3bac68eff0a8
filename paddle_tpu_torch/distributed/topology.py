"""Hybrid-parallel topology (counterpart: paddle_tpu/distributed/
topology.py).

`CommunicateTopology` is the host-only N-D rank grid, copied.  The JAX
package's `build_mesh` returns a ``jax.sharding.Mesh`` of devices; torch
has no device-mesh object a rank could hold, so here it returns the
`CommunicateTopology` of those degrees over the axes ``("dp", "pp",
"sp", "mp")``, whose ``shape`` reads like the mesh's.

`HybridCommunicateGroup` lays the world's ranks out on that grid (dp
outermost, mp innermost, as JAX's mesh; the sharding degree folds into
dp as there) and builds one ``torch.distributed`` group for each line
of each axis (`CommunicateTopology.get_comm_list`), so a rank holds its
dp, pp, sp and mp groups (`collective.Group`) and answers the
reference's rank queries.  With ``sharding > 1`` the dp axis splits
into ``dp / sharding`` data replicas of ``sharding`` ranks each, and
the sharding group is a replica's ranks; otherwise ZeRO shards over the
whole dp axis, as the JAX package's does.  Every rank builds every
group, in one order, as ``torch.distributed.new_group`` requires.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import parallel as _par

__all__ = ["AXIS_ORDER", "CommunicateTopology", "build_mesh",
           "HybridCommunicateGroup", "set_hybrid_communicate_group",
           "get_hybrid_communicate_group"]

AXIS_ORDER = ("dp", "pp", "sp", "mp")

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


class HybridCommunicateGroup:
    """This rank's place on the (dp, pp, sp, mp) grid and its groups."""

    def __init__(self, topology: CommunicateTopology = None, mesh=None,
                 dp=None, pp=1, sp=1, mp=1, sharding=1):
        if topology is not None:
            degs = dict(zip(topology.get_hybrid_group_names(),
                            topology._dims))
            dp = degs.get("data", dp)
            pp, mp = degs.get("pipe", pp), degs.get("model", mp)
            sharding = degs.get("sharding", sharding)
            if dp is not None:
                dp = int(dp) * max(int(sharding), 1)
        if mesh is not None:
            dp = mesh.shape.get("dp", dp)
            pp, sp = mesh.shape.get("pp", pp), mesh.shape.get("sp", sp)
            mp = mesh.shape.get("mp", mp)
        pp, sp, mp = int(pp), int(sp), int(mp)
        sharding = max(int(sharding), 1)
        world = _par.get_world_size()
        if dp is None:
            dp = world // (pp * sp * mp)
        dp = int(dp)
        if dp * pp * sp * mp != world:
            raise ValueError(
                f"hybrid degrees dp={dp} x pp={pp} x sp={sp} x mp={mp} = "
                f"{dp * pp * sp * mp} must equal the world size {world} "
                f"(one rank a process)")
        if dp % sharding:
            raise ValueError(f"sharding degree {sharding} must divide the "
                             f"data-parallel degree {dp}")
        self._dp, self._pp, self._sp, self._mp = dp, pp, sp, mp
        self._sharding = sharding
        self._topo = CommunicateTopology(("data", "pipe", "sharding",
                                          "model"),
                                         (dp // sharding, pp, sharding, mp))
        self._mesh = build_mesh(dp=dp, pp=pp, sp=sp, mp=mp)
        self.global_rank = _par.get_rank()
        self._coord = dict(zip(AXIS_ORDER,
                               self._mesh.get_coord(self.global_rank)))
        self._groups = {ax: self._axis_group(ax) for ax in AXIS_ORDER}
        self._groups["sharding"] = self._sharding_group()

    def _build(self, name, lines):
        """One group a line (every rank calls ``new_group`` for each
        line of more than one rank); this rank's."""
        from .collective import Group, new_group

        mine = None
        for line in lines:
            if len(line) > 1 and _par._dist() is not None:
                g = new_group(line, axis_name=name)
            else:
                g = Group(name, line, id=0, pg=None)
            if self.global_rank in line:
                mine = g
        return mine

    def _axis_group(self, axis):
        return self._build(axis, self._mesh.get_comm_list(axis))

    def _sharding_group(self):
        if self._sharding <= 1:
            return self._groups["dp"]
        lines = []
        for dp_line in self._mesh.get_comm_list("dp"):
            for i in range(0, self._dp, self._sharding):
                lines.append(dp_line[i:i + self._sharding])
        return self._build("sharding", lines)

    @property
    def mesh(self) -> CommunicateTopology:
        return self._mesh

    def axis_group(self, axis):
        """The group of this rank along ``axis`` ("dp", "pp", "sp", "mp"
        or "sharding")."""
        return self._groups[axis]

    def axis_rank(self, axis) -> int:
        return self._groups[axis].rank

    def axis_size(self, axis) -> int:
        return self._groups[axis].nranks

    # -- degree queries (the reference's API) -------------------------------
    def get_data_parallel_world_size(self):
        return self._dp

    def get_model_parallel_world_size(self):
        return self._mp

    def get_pipe_parallel_world_size(self):
        return self._pp

    def get_sharding_parallel_world_size(self):
        return self._sharding if self._sharding > 1 else self._dp

    def get_sequence_parallel_world_size(self):
        return self._sp

    def get_parallel_mode(self):
        if self._mp == 1 and self._pp == 1 and self._sharding <= 1:
            return "data_parallel"
        if self._sharding > 1 and self._mp == 1 and self._pp == 1:
            return "sharding_parallel"
        if self._mp > 1 and self._pp == 1:
            return "tensor_parallel"
        return "pipeline_parallel"

    # -- rank queries --------------------------------------------------------
    def get_global_rank(self):
        return self.global_rank

    def get_data_parallel_rank(self):
        return self._coord["dp"]

    def get_model_parallel_rank(self):
        return self._coord["mp"]

    def get_sequence_parallel_rank(self):
        return self._coord["sp"]

    def get_sharding_parallel_rank(self):
        return self._groups["sharding"].rank

    def get_stage_id(self):
        return self._coord["pp"]

    def is_first_stage(self):
        return self._coord["pp"] == 0

    def is_last_stage(self):
        return self._coord["pp"] == self._pp - 1

    # -- groups ----------------------------------------------------------------
    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_sequence_parallel_group(self):
        return self._groups["sp"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_data_parallel_group_src_rank(self):
        return self._groups["dp"].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].ranks[0]

    def get_sharding_parallel_group_src_rank(self):
        return self._groups["sharding"].ranks[0]

    def get_rank_from_stage(self, stage_id):
        """The global rank at pipeline stage ``stage_id`` with this rank's
        other coordinates."""
        return self._groups["pp"].ranks[stage_id]

    def topology(self):
        return self._topo


_HCG: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: HybridCommunicateGroup):
    global _HCG
    _HCG = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _HCG

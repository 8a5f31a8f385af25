"""Build the one fleet-bound model a "packed" group runs as
(``raft_tpu/fleet/packer.py``).

The packed model is the group's representative params with the config
axis switched on: ``fleet=True`` adds the ``fleet_job`` and ``c_<name>``
VIEW lanes (``models/base.py`` FleetConstMixin), each varying constant is
set to its group MAXIMUM (``fleet_bind`` checks it: the static value sizes
capacity, the lane gates the guards), and the per-job constant table is
bound so ``init_states`` stamps one job-major copy of the initial states
per job.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .grouping import FleetGroup


def build_packed(group: FleetGroup):
    if group.kind != "packed":
        raise ValueError(f"build_packed needs a packed group, not {group.kind!r}")
    setups = group.setups
    m0 = setups[0].model
    over = {n: max(int(getattr(s.model.p, n)) for s in setups) for n in group.dyn_consts}
    rep = dataclasses.replace(m0.p, fleet=True, dyn_consts=tuple(group.dyn_consts), **over)
    model = type(m0)(rep, server_names=list(setups[0].server_names),
                     value_names=list(setups[0].value_names))
    model.name = m0.name  # the registry names the variants after construction
    table = group.table
    if table is None:
        table = np.zeros((len(setups), 0), dtype=np.int64)
    model.fleet_bind(table)
    return model

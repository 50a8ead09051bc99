"""Spectra for a stream of atmospheres: the driver of the traffic kind
``forward``."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from spectrobench import drivers
from spectrobench.drivers import SPAN, now, worst
from spectrobench.inputs import STREAM_CHECK, rng


class Driver(drivers.Driver):
    """Spectra for a stream of atmospheres in a closed loop, one at a time:
    the forward ``cli.scene_forward`` builds (on a mesh: the nu-halo mesh
    forward of ``cli.sharded_problem``) called on a state holding the
    atmosphere's temperature and CO2 VMR; its radiances come back to the
    host."""

    # The CLI's forward keeps the scene's atmosphere in float64.
    state_dtype = torch.float64

    def setup(self) -> None:
        from spectrobot_tpu_torch.retrieval.state import (
            flatten_state, make_state)
        self._build()
        atm = self.scene.atm
        self.dtype = atm.T.dtype
        template = make_state(atm, ["CO2"])
        self.flatten = lambda s: flatten_state(s)[0]
        if self.mesh is None:
            self.fwd = self.cli.scene_forward(self.cfg, self.scene,
                                              engine=self.engine)
        else:
            self.oe = self.cli.sharded_problem(self.cfg, self.scene,
                                               self.mesh, atm, template,
                                               self.engine)
        for i in range(3):
            self.unit(i)
        self.kept = {}

    def _state(self, a: dict) -> dict:
        t = lambda v: torch.as_tensor(v, dtype=self.dtype,
                                      device=self.device)
        return {"T": t(a["T"]), "ln_vmr": {"CO2": torch.log(t(a["vmr"]))}}

    def unit(self, i: int) -> dict:
        k = int(self.inputs.order[i % len(self.inputs.pool)])
        a = self.inputs.pool[k]
        t0 = now()
        with record_function(SPAN + "state"):
            state = self._state(a)
        self._record("forward", a["T"], a["vmr"])
        with record_function(SPAN + "forward"):
            if self.mesh is None:
                y = self.fwd(state)
            else:
                y = self.oe.forward_flat(self.flatten(state))
        t1 = now()
        with record_function(SPAN + "to_host"):
            y = y.cpu().numpy()
        t2 = now()
        lo_hi = self.kept.get(k)
        y = y.astype(np.float64)
        self.kept[k] = ((y, y) if lo_hi is None else
                        (np.minimum(lo_hi[0], y), np.maximum(lo_hi[1], y)))
        return {"wall_s": t2 - t0, "issue_s": t1 - t0, "pool": k}

    def check(self, control: bool = False) -> dict:
        """rad_gap: every delivered spectrum against the reference's of its
        atmosphere, the largest gap over max |y_ref| (the spectra of one
        atmosphere are held as their elementwise least and largest).  A
        configuration's ``check_sample`` compares the spectra of that many
        atmospheres, drawn from the seed."""
        sc, dev, ref = self.inputs.scene, self.device, self.inputs.ref
        gap = cgap = 0.0
        keys = sorted(self.kept)
        n = self.inputs.bench.get("check_sample")
        if n is not None and n < len(keys):
            g = rng(self.inputs.seed, STREAM_CHECK)
            keys = sorted(int(k) for k in g.choice(keys, int(n),
                                                   replace=False))
        for k in keys:
            a = self.inputs.pool[k]
            y_ref = ref.forward(sc, a["T"], a["vmr"], "float32", dev,
                                self.state_dtype).cpu().double().numpy()
            lo, hi = self.kept[k]
            scale = np.abs(y_ref).max()
            gap = worst(gap, max(np.abs(lo - y_ref).max(),
                                 np.abs(hi - y_ref).max()) / scale)
            if control:
                y_c = ref.forward(sc, a["T"], a["vmr"], "tf32", dev,
                                  self.state_dtype).cpu().double().numpy()
                cgap = worst(cgap, np.abs(y_c - y_ref).max() / scale)
        return {"program": {"rad_gap": gap},
                "control": {"rad_gap": cgap} if control else None,
                "checked": len(keys)}

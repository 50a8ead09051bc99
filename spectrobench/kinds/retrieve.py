"""A retrieval campaign: the driver of the traffic kind ``retrieve``."""

from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch.profiler import record_function

from spectrobench import drivers
from spectrobench.drivers import SPAN, now, sync, worst
from spectrobench.inputs import STREAM_CHECK, STREAM_NOISE, rng


class Driver(drivers.Driver):
    """A retrieval campaign in a closed loop: per scan the calls the CLI's
    ``retrieve`` makes after ``build_scene`` (``retrieval_problem``,
    ``make_jacobian``, ``retrieval.oe.retrieve``, the fitted forward), on
    observations the reference made from the pool's truths."""

    @property
    def state_dtype(self) -> torch.dtype:
        """The CLI's retrieval holds its state in the compute dtype."""
        return (torch.float64 if self.cfg.compute.dtype == "float64"
                else torch.float32)

    def setup(self) -> None:
        from spectrobot_tpu_torch.retrieval.oe import OEConfig
        self._build()
        tr, cfg = self.inputs.traffic, self.cfg
        t0 = now()
        truths = self._truth_spectra()
        self.reference_s = now() - t0
        g = rng(self.inputs.seed, STREAM_NOISE)
        self.obs = []
        for y in truths:
            sigma = tr["noise_frac"] * float(y.max())
            self.obs.append((y + sigma * g.standard_normal(y.shape),
                             np.full_like(y, sigma)))
        n_lev = cfg.scene.n_levels
        self.S_a = np.diag(np.full(n_lev, cfg.retrieval.sigma_T ** 2))
        self.oe_cfg = OEConfig(max_iter=int(tr["max_iter"]),
                               lm_lambda0=cfg.retrieval.lm_lambda0,
                               chi2_rel_tol=cfg.retrieval.chi2_rel_tol)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.unit(0)
        self.kept = {}

    def _truth_spectra(self) -> np.ndarray:
        """The reference's spectra of the pool's truths [pool, n_y], without
        noise: read from the benchmark's cache where a run of the same
        inputs on the same kind of device left them, else computed and
        kept there.  The key digests everything they are computed from:
        the reference's source, the scene, the truths, the state's dtype,
        the device and PyTorch."""
        inp, dev = self.inputs, self.device
        vmr = inp.prior["vmr"]
        h = hashlib.sha256()
        with open(inp.ref.__file__, "rb") as f:
            h.update(f.read())
        _digest(h, (tuple(inp.scene), [a["T"] for a in inp.pool], vmr,
                    str(self.state_dtype), torch.__version__,
                    torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else dev.type))
        path = drivers.cache_dir() / f"truths-{h.hexdigest()[:40]}.npy"
        if path.exists():
            return np.load(path)
        y = np.stack([inp.ref.forward(inp.scene, a["T"], vmr, "float32", dev,
                                      self.state_dtype).cpu().double().numpy()
                      for a in inp.pool])
        path.parent.mkdir(parents=True, exist_ok=True)
        part = path.with_suffix(".part.npy")
        np.save(part, y)
        part.replace(path)
        return y

    def _timed(self, fn, kind: str, log: list):
        vmr = self.inputs.prior["vmr"]

        def call(x):
            self._record(kind, x, vmr)
            t0 = now()
            with record_function(SPAN + kind):
                out = fn(x)
                sync(self.device)
            log.append(now() - t0)
            return out
        return call

    def unit(self, i: int) -> dict:
        from spectrobot_tpu_torch.retrieval.oe import retrieve
        k = int(self.inputs.order[i % len(self.obs)])
        y_obs, sigma = self.obs[k]
        fwd_s, jac_s = [], []
        t0 = now()
        with record_function(SPAN + "problem"):
            prob = self.cli.retrieval_problem(self.cfg, self.scene,
                                              self.engine)
            n_x = int(prob.x0.shape[0])
            jac = self.cli.make_jacobian(self.cfg, prob.fwd_flat, n_x,
                                         int(self.scene.nu.shape[0]),
                                         self.device)
        fwd = self._timed(prob.fwd_flat, "forward", fwd_s)
        with record_function(SPAN + "lm_loop"):
            res = retrieve(fwd, self._timed(jac, "jacobian", jac_s), y_obs,
                           prob.x0, prob.x0, self.S_a, sigma, self.oe_cfg)
        y_fit = fwd(torch.as_tensor(res.x, dtype=prob.x0.dtype,
                                    device=self.device))
        with record_function(SPAN + "to_host"):
            y_fit = y_fit.cpu().numpy()
        wall = now() - t0
        rec = {"wall_s": wall, "converged": bool(res.converged),
               "n_iter": int(res.n_iter), "forward_s": fwd_s,
               "jacobian_s": jac_s, "pool": k}
        old = self.kept.get(k)
        if old is None or wall > old["wall_s"]:
            self.kept[k] = {**rec, "x": np.asarray(res.x, np.float64),
                            "x_a": prob.x0.double().cpu().numpy(),
                            "y_fit": y_fit.astype(np.float64),
                            "chi2": float(res.chi2),
                            "K": np.asarray(res.K, np.float64)}
        return rec

    def check(self, control: bool = False) -> dict:
        """Per kept scan (the longest of each observation), at the state
        the loop returned: fit_gap, the fitted spectrum against the
        reference's (max gap over max |y_ref|); jac_gap, the final
        Jacobian along a seeded direction against the reference's
        derivative there; chi2_gap, the loop's final cost against the
        reference's cost at the same state (relative); fit_chi2, the
        reference's measurement chi^2 per observation there (about 1 at a
        solution).  The largest of each over the scans.  unconverged, the
        window's scans that did not converge, is attached by the
        caller."""
        sc, dev, ref = self.inputs.scene, self.device, self.inputs.ref
        vmr = self.inputs.prior["vmr"]
        S_a_inv = np.linalg.inv(self.S_a)
        g = rng(self.inputs.seed, STREAM_CHECK)
        out = {"fit_gap": 0.0, "jac_gap": 0.0, "chi2_gap": 0.0,
               "fit_chi2": 0.0}
        ctrl = dict.fromkeys(out, 0.0)
        for k in sorted(self.kept):
            kp = self.kept[k]
            y_obs, sigma = self.obs[k]
            v = g.standard_normal(kp["x"].shape)
            y_ref, dy_ref = (a.cpu().double().numpy() for a in ref.jvp(
                sc, kp["x"], vmr, v, np.zeros_like(vmr), "float32", dev,
                self.state_dtype))
            dxa = kp["x"] - kp["x_a"]
            prior = float(dxa @ S_a_inv @ dxa)

            def meas(y):
                return float(np.sum(((y_obs - y) / sigma) ** 2))

            cost = lambda y: meas(y) + prior
            chi2_ref = cost(y_ref)
            scale_y, scale_j = np.abs(y_ref).max(), np.abs(dy_ref).max()
            got = {"fit_gap": np.abs(kp["y_fit"] - y_ref).max() / scale_y,
                   "jac_gap": np.abs(kp["K"] @ v - dy_ref).max() / scale_j,
                   "chi2_gap": abs(kp["chi2"] - chi2_ref) / chi2_ref,
                   "fit_chi2": meas(y_ref) / y_ref.size}
            out = {n: worst(out[n], got[n]) for n in out}
            if control:
                y_c, dy_c = (a.cpu().double().numpy()
                             for a in ref.jvp(sc, kp["x"], vmr, v,
                                              np.zeros_like(vmr), "tf32",
                                              dev, self.state_dtype))
                got = {"fit_gap": np.abs(y_c - y_ref).max() / scale_y,
                       "jac_gap": np.abs(dy_c - dy_ref).max() / scale_j,
                       "chi2_gap": abs(cost(y_c) - chi2_ref) / chi2_ref,
                       "fit_chi2": meas(y_c) / y_ref.size}
                ctrl = {n: worst(ctrl[n], got[n]) for n in ctrl}
        return {"program": out, "control": ctrl if control else None,
                "checked": len(self.kept)}


def _digest(h, obj) -> None:
    """Feed ``obj`` (arrays, numbers, strings and their dicts, lists and
    tuples) into the hash ``h``, its structure with it."""
    if isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj):
            _digest(h, k)
            _digest(h, obj[k])
        h.update(b"}")
    elif isinstance(obj, (list, tuple)):
        h.update(b"[")
        for v in obj:
            _digest(h, v)
        h.update(b"]")
    else:
        a = np.asarray(obj)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes() if a.dtype != object else repr(obj).encode())

"""The library walkthrough: limb spectra and a closed-loop retrieval (a
port of the reference's ``examples/run_demo.py``).

    python -m spectrobot_tpu_torch.run_demo [--device {cuda,cpu}]
        [--out DIR]

A Mars CO2 15 um limb scan (``co2_15um_band(j_max=30)``, 2048 points over
655-680 cm-1, 8 rays at 6-70 km, 15 levels to 80 km): the forward through
K1 (``forward.limb.limb_radiance``) and ``limb_radiances.png``; the
Spectrum family (``spectra.radiance``: brightness temperature, band
integral, ``limb_spectrum.npz``); then a temperature retrieval on a
64-channel ILS at 0.5 cm-1 (``retrieval.state.build_forward``, n_sub 2)
from observations with noise 0.004 max y (``numpy.random.default_rng(0)``),
started 7 K off with a 10 K prior sigma, its Jacobians by
``torch.func.jacfwd`` (K1 + K2), ``retrieval.oe.retrieve`` and
``retrieved_T.png`` (the two figures only where matplotlib is
installed).  float32 on the card, float64 on the CPU (as the
reference takes float32 on its chip and float64 elsewhere).  Files go to
``--out`` (default ``examples/out_demo_torch/``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from spectrobot_tpu_torch import cli
from spectrobot_tpu_torch.data.atmosphere import MARS, mars_standard_atmosphere
from spectrobot_tpu_torch.data.synth import co2_15um_band
from spectrobot_tpu_torch.forward.geometry import limb_path_cg
from spectrobot_tpu_torch.forward.limb import limb_radiance
from spectrobot_tpu_torch.ops.ils import ils_matrix
from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist
from spectrobot_tpu_torch.retrieval.oe import OEConfig, retrieve
from spectrobot_tpu_torch.retrieval.state import (
    build_forward, flatten_state, make_state)
from spectrobot_tpu_torch.spectra import radiance as radiance_spectrum
from spectrobot_tpu_torch.utils.plots import plot_radiances, plot_retrieval

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "out_demo_torch")


def _figure(plot, path: str, *args, **kw):
    """``plot(path, ...)``, or None where matplotlib is not installed (the
    figures are optional, as the CLI's are)."""
    try:
        return plot(path, *args, **kw)
    except ImportError as e:
        print(f"figure {os.path.basename(path)} skipped: {e}")
        return None


def run(device, out_dir: str = OUT, n_points: int = 2048,
        max_iter: int = 10) -> dict:
    """The walkthrough on ``device``, its files in ``out_dir``.  Returns
    the radiances ``I`` [8, n_points], the retrieval's result ``res``, the
    true and first states ``x_true``, ``x0`` and the observations
    ``y_obs`` (host arrays)."""
    os.makedirs(out_dir, exist_ok=True)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)

    # The scene: a Mars CO2 15 um limb scan.
    atm = mars_standard_atmosphere(n_lev=15, z_top=80e3,
                                   device=device).to(dtype)
    lines = device_lines_from_linelist(co2_15um_band(j_max=30), [(2, 1)],
                                       dtype=dtype, device=device)
    nu_host = np.linspace(655.0, 680.0, n_points)
    nu, nu_off = t(nu_host), t(nu_host - float(lines.nu_ref))
    h_t = t(np.linspace(6e3, 70e3, 8))

    # The forward.
    cg = limb_path_cg(atm, ["CO2"], h_t, MARS)
    I = limb_radiance(nu, lines, cg, nu_off=nu_off).cpu().numpy()
    print(f"forward radiances: {I.shape}, peak {float(I.max()):.3e} "
          f"W/m2/sr/cm-1")
    h_km = h_t.cpu().numpy() / 1e3
    figures = [_figure(plot_radiances,
                       os.path.join(out_dir, "limb_radiances.png"), nu_host,
                       I, labels=[f"{h:.0f} km" for h in h_km])]

    # The Spectrum family: units, conversions, band integrals, files.
    sp = radiance_spectrum(nu_host, I)
    tb = sp.brightness_temperature()
    band = np.asarray(sp.integrate())
    print(f"Spectrum: {sp} [{sp.units}]; lowest-ray T_B peak "
          f"{float(np.asarray(tb.values)[0].max()):.1f} K; band radiance "
          f"{band[0]:.3e} W/m2/sr")
    sp.save_npz(os.path.join(out_dir, "limb_spectrum.npz"),
                tangent_heights_km=h_km)

    # The closed-loop retrieval.
    W = t(ils_matrix(nu_host, np.linspace(657, 678, 64), 0.5))
    fwd = build_forward(atm, lines, nu, ["CO2"], MARS, tangent_heights_m=h_t,
                        ils_W=W, n_sub=2, nu_off=nu_off)
    x_true, unravel = flatten_state(make_state(atm, []))
    fwd_flat = lambda x: fwd(unravel(x))
    y_clean = fwd_flat(x_true).cpu().numpy().astype(np.float64)
    noise = 0.004 * y_clean.max()
    rng = np.random.default_rng(0)
    y_obs = y_clean + noise * rng.standard_normal(y_clean.shape)
    x0 = x_true + 7.0                       # started 7 K off
    jac = torch.func.jacfwd(fwd_flat)
    res = retrieve(fwd_flat, jac, t(y_obs), x0, x0,
                   np.diag(np.full(x0.shape[0], 10.0 ** 2)),
                   np.full(y_obs.shape, noise), OEConfig(max_iter=max_iter))
    x_true_h = x_true.cpu().numpy().astype(np.float64)
    errs = np.abs(res.x - x_true_h)
    print(f"retrieval: converged={res.converged} iters={res.n_iter} "
          f"chi2/n={res.chi2_meas / len(y_obs):.2f} dof={res.dof:.1f} "
          f"mean|dT|={errs.mean():.2f} K (started at 7 K)")
    figures.append(_figure(
        plot_retrieval, os.path.join(out_dir, "retrieved_T.png"),
        atm.z.cpu().numpy(), res.x, x0.cpu().numpy(),
        T_sigma=np.sqrt(np.diag(res.S_hat)), T_true=x_true_h))
    print(f"files in {out_dir}/")
    return {"I": I, "res": res, "x_true": x_true_h,
            "x0": x0.cpu().numpy().astype(np.float64), "y_obs": y_obs,
            "figures": [f for f in figures if f is not None]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spectrobot_tpu_torch.run_demo")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    device = cli.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

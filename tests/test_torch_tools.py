"""The port's trace summary, Jacobian timer and library walkthrough
(spectrobot_tpu_torch.trace_summary, .jac_kernel_bench and .run_demo, the
ports of benchmarks/trace_summary.py, benchmarks/jac_kernel_bench.py and
examples/run_demo.py) on the CPU: the summary's families, order and loop
flag on a synthetic event list and on a CPU trace of the bench's fused
scene; the Jacobian timer's JSON line; and the walkthrough against the
same steps through the JAX package in float64."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward.geometry import limb_path_cg
from spectrobot_tpu.forward.limb import limb_radiance
from spectrobot_tpu.ops.ils import ils_matrix
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.retrieval.oe import OEConfig, retrieve
from spectrobot_tpu.retrieval.state import (
    build_forward, flatten_state, make_state)
from spectrobot_tpu_torch import jac_kernel_bench, run_demo, trace_summary

CPU = torch.device("cpu")
torch.set_num_threads(1)


def _events(spec):
    """[(name, start, end)] from (name, duration_us, count) triples laid
    end to end."""
    out, t = [], 0.0
    for name, dur, count in spec:
        for _ in range(count):
            out.append((name, t, t + dur))
            t += dur
    return out


def test_summarize_groups_orders_and_flags():
    """The anonymous namespace, template arguments, argument lists and
    trailing digits go; the largest family comes first; a family of >= 100
    launches a call and more than 5 % of the total is flagged, a large
    single launch is not."""
    work = _events([
        ("void (anonymous namespace)::basis_batch_kernel<4, true>"
         "(float const*, int)", 3000.0, 2),
        ("void (anonymous namespace)::basis_batch_kernel<2, false>"
         "(float const*, int)", 1000.0, 2),
        ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3> >"
         "(int, at::native::CUDAFunctor_add<float>, "
         "at::detail::Array<char*, 3>)", 5.0, 600),
        ("Memcpy HtoD (Pageable -> Device)", 1.0, 4),
        ("fusion.12", 2.0, 2), ("fusion.7", 2.0, 2)])
    rows = trace_summary.summarize(work, n_reps=2)
    names = [r[2] for r in rows]
    assert names == ["basis_batch_kernel",
                     "at::native::vectorized_elementwise_kernel",
                     "fusion", "Memcpy HtoD"]
    ms, launches, _ = rows[0]
    assert ms == 4.0 and launches == 2.0          # (6000 + 2000) us / 2
    assert rows[1][:2] == (1.5, 300.0)
    total = sum(r[0] for r in rows)
    assert [trace_summary.flagged(r, total) for r in rows] == [
        False, True, False, False]
    assert [ms for ms, _, _ in rows] == sorted(
        (ms for ms, _, _ in rows), reverse=True)


def test_summary_of_a_cpu_trace(tmp_path):
    """The fused scene's forward traced on the CPU: the operators the
    window called, largest first, the line sum's among them, and the
    Chrome trace written."""
    rows = trace_summary.capture(CPU, "forward", reps=1, log_dir=tmp_path)
    assert rows and all(ms >= 0 and n >= 1 for ms, n, _ in rows)
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)
    assert "LineSum" in [r[2] for r in rows]
    assert (tmp_path / "trace.json").exists()


def test_jac_kernel_bench_line(capsys):
    jac_kernel_bench.main(["cpu-check", "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(last)
    assert set(rec) == {"label", "fwd_ms", "jac_ms", "total_ms", "card"}
    assert rec["label"] == "cpu-check" and rec["card"] == "cpu"
    assert rec["fwd_ms"] > 0 and rec["jac_ms"] > 0
    assert abs(rec["total_ms"] - rec["fwd_ms"] - rec["jac_ms"]) <= 1e-9 * \
        rec["total_ms"]


def _jax_walkthrough(n_points, max_iter):
    """examples/run_demo.py's steps through the JAX package, float64:
    (radiances, retrieval result)."""
    f64 = jnp.float64
    atm = jax.tree.map(lambda a: jnp.asarray(a, f64),
                       mars_standard_atmosphere(n_lev=15, z_top=80e3))
    lines = j_stage(co2_15um_band(j_max=30), [(2, 1)], dtype=f64)
    nu_host = np.linspace(655.0, 680.0, n_points)
    nu = jnp.asarray(nu_host)
    nu_off = jnp.asarray(nu_host - float(lines.nu_ref))
    h_t = jnp.asarray(np.linspace(6e3, 70e3, 8))
    cg = limb_path_cg(atm, ["CO2"], h_t, J_MARS)
    I = np.asarray(jax.jit(lambda: limb_radiance(nu, lines, cg,
                                                 nu_off=nu_off))())
    W = jnp.asarray(ils_matrix(nu_host, np.linspace(657, 678, 64), 0.5))
    fwd = build_forward(atm, lines, nu, ["CO2"], J_MARS,
                        tangent_heights_m=h_t, ils_W=W, n_sub=2,
                        nu_off=nu_off)
    x_true, unravel = flatten_state(make_state(atm, []))
    fwd_flat = jax.jit(lambda x: fwd(unravel(x)))
    y_clean = np.asarray(fwd_flat(x_true))
    noise = 0.004 * y_clean.max()
    y_obs = y_clean + noise * np.random.default_rng(0).standard_normal(
        y_clean.shape)
    x0 = x_true + 7.0
    jac = jax.jit(lambda x: jax.jacfwd(fwd_flat)(x))
    res = retrieve(fwd_flat, jac, jnp.asarray(y_obs), x0, x0,
                   np.diag(np.full(x0.shape[0], 10.0 ** 2)),
                   jnp.full(y_obs.shape, noise), OEConfig(max_iter=max_iter))
    return I, res


def test_run_demo_matches_the_reference_walkthrough(tmp_path):
    """run_demo.run at 256 points and 3 LM iterations, float64 on the CPU:
    radiances within 1e-10 of max, the retrieved state within 1e-8 after
    the same number of iterations; the two figures and the spectrum
    file written."""
    out = run_demo.run(CPU, str(tmp_path), n_points=256, max_iter=3)
    I_ref, res_ref = _jax_walkthrough(256, 3)
    assert out["I"].shape == I_ref.shape == (8, 256)
    assert np.max(np.abs(out["I"] - I_ref)) <= 1e-10 * np.abs(I_ref).max()
    res = out["res"]
    assert res.n_iter == res_ref.n_iter
    np.testing.assert_allclose(res.x, np.asarray(res_ref.x), rtol=1e-8)
    for name in ("limb_radiances.png", "retrieved_T.png",
                 "limb_spectrum.npz"):
        assert os.path.getsize(tmp_path / name) > 0
    assert len(out["figures"]) == 2

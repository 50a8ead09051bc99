"""The forward slice of the PyTorch port against the JAX reference: geometry,
the RT integrator and the batched line sum on inputs carried over by
spectrobot_tpu_torch.interop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band
from spectrobot_tpu.forward import geometry as jgeo
from spectrobot_tpu.forward import limb as jlimb
from spectrobot_tpu.forward import rt as jrt
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.forward import geometry as tgeo
from spectrobot_tpu_torch.forward import limb as tlimb
from spectrobot_tpu_torch.forward import rt as trt
from spectrobot_tpu_torch.kernels import launch
from spectrobot_tpu_torch.ops import cuda_opacity as co

CPU = torch.device("cpu")


def _numpy(nt) -> dict:
    return {k: (v if v is None or isinstance(v, (bool, int))
                else np.asarray(v)) for k, v in nt._asdict().items()}


def _atm_pair(n_lev=9, z_top=70e3):
    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=z_top)
    d = {k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")}
    d["vmr"] = {k: np.asarray(v) for k, v in atm.vmr.items()}
    return atm, interop.atmosphere_from_numpy(d, device=CPU)


def _assert_cg_close(got, ref, rtol):
    for name in ref._fields:
        r, g = getattr(ref, name), getattr(got, name)
        if name in ("seg_count", "is_limb"):
            assert g == r, name
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                       atol=0, err_msg=name)


def test_limb_path_cg_f64():
    jatm, tatm = _atm_pair()
    h = np.array([3e3, 8e3, 30e3, 55e3])
    ref = jgeo.limb_path_cg(jatm, ["CO2", "H2O"], jnp.asarray(h), J_MARS, 3)
    got = tgeo.limb_path_cg(tatm, ["CO2", "H2O"], torch.as_tensor(h), MARS,
                            3)
    _assert_cg_close(got, ref, 1e-10)
    # Layers below each tangent point carry zero column.
    assert float(got.u[3, 0, 0]) == 0.0 and float(got.u[0, -1, 0]) > 0.0


def test_nadir_path_cg_f64():
    jatm, tatm = _atm_pair()
    sec = np.array([1.0, 1.7])
    ref = jgeo.nadir_path_cg(jatm, ["CO2"], jnp.asarray(sec), 4)
    got = tgeo.nadir_path_cg(tatm, ["CO2"], torch.as_tensor(sec), 4)
    _assert_cg_close(got, ref, 1e-10)


def test_path_cg_interop_roundtrip():
    jatm, _ = _atm_pair()
    ref = jgeo.limb_path_cg(jatm, ["CO2"], jnp.asarray([8e3]), J_MARS, 2)
    got = interop.path_cg_from_numpy(_numpy(ref), device=CPU)
    _assert_cg_close(got, ref, 0)
    assert got.seg_layer.dtype == torch.int64


@pytest.mark.parametrize("with_background", [False, True])
def test_layer_path_radiance_f64(with_background):
    rng = np.random.default_rng(0)
    R, NL, P = 3, 6, 40
    dtau = rng.uniform(0.0, 0.8, (R, NL, P))
    src = rng.uniform(0.0, 2.0, (R, NL, P))
    bg = rng.uniform(0.0, 1.0, (R, P)) if with_background else None
    for seg in (np.concatenate([np.arange(NL)[::-1], np.arange(NL)]),
                np.arange(NL)[::-1].copy()):
        ref = jrt.layer_path_radiance(jnp.asarray(dtau), jnp.asarray(src),
                                      jnp.asarray(seg),
                                      None if bg is None else jnp.asarray(bg))
        got = trt.layer_path_radiance(torch.as_tensor(dtau),
                                      torch.as_tensor(src),
                                      torch.as_tensor(seg),
                                      None if bg is None
                                      else torch.as_tensor(bg))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=0)


def test_layer_tau_kernel_matches_pallas_interpret():
    """The batched line sum through the kernel wrapper (plain version on
    CPU tensors) against layer_tau_pallas in interpret mode, float32."""
    atm = mars_standard_atmosphere(n_lev=9, z_top=70e3)
    atm = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, atm)
    dl = j_stage(co2_15um_band(j_max=12), [(2, 1)], dtype=jnp.float32)
    nu_host = np.linspace(655.0, 680.0, 500)
    nu_off = jnp.asarray(nu_host - float(dl.nu_ref), jnp.float32)
    cg = jgeo.limb_path_cg(atm, ["CO2"], jnp.asarray([8e3, 30e3],
                                                     jnp.float32), J_MARS, 2)
    ref = jlimb.layer_tau_pallas(jnp.asarray(nu_host, jnp.float32), dl, cg,
                                 cutoff_cm1=25.0, nu_off=nu_off,
                                 interpret=True)
    tl = interop.device_lines_from_numpy(_numpy(dl), device=CPU)
    tcg = interop.path_cg_from_numpy(_numpy(cg), device=CPU)
    before = launch.LAUNCHES["opacity_batch_kernel"]
    t_nu_off = torch.tensor(np.asarray(nu_off))
    got = tlimb.layer_tau_kernel(t_nu_off, tl, tcg,
                                 co.line_windows(t_nu_off, tl.nu0),
                                 cutoff_cm1=25.0)
    assert launch.LAUNCHES["opacity_batch_kernel"] == before
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=3e-5,
                                   atol=np.abs(r).max() * 1e-6)

"""The 3xTF32 arithmetic of the tensor-core basis contraction (K2 and K4,
``spectrobot_tpu_torch/csrc/basis_contract.cuh``), emulated in plain
PyTorch on the CPU: each operand is split into hi = tf32(a) and
lo = tf32(a - hi), rounded to nearest even to 10 mantissa bits, and the
product taken as hi.hi + hi.lo + lo.hi (lo.lo dropped).  On the plain
version's float32 basis, the emulation is held to the reference's Pallas
kernel in interpret mode and, through a 33-column Jacobian, to jax.jacfwd,
within the reference's 1e-5 max|ref| (tests/test_pallas_jacobian.py).
The one-pass TF32 error is printed, not asserted: it is what three passes
buy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectrobot_tpu.data.atmosphere import MARS as J_MARS
from spectrobot_tpu.data.atmosphere import mars_standard_atmosphere
from spectrobot_tpu.data.synth import co2_15um_band, random_lines
from spectrobot_tpu.ops import opacity as jop
from spectrobot_tpu.ops.pallas_opacity import basis_contract_pallas_batch_jit
from spectrobot_tpu.ops.strengths import device_lines_from_linelist as j_stage
from spectrobot_tpu.retrieval import state as jstate
from spectrobot_tpu_torch import interop
from spectrobot_tpu_torch.data.atmosphere import MARS
from spectrobot_tpu_torch.ops import cuda_basis as cb
from spectrobot_tpu_torch.ops.opacity import _basis
from spectrobot_tpu_torch.retrieval import state as tstate

CPU = torch.device("cpu")
REL = 1e-5           # tests/test_pallas_jacobian.py:124,182
torch.set_num_threads(1)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32 (10 mantissa bits), to nearest even,
    as float32 with the low 13 bits zero (the kernel's tf32_rne)."""
    u = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x0FFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def split(a: torch.Tensor) -> tuple:
    hi = tf32(a)
    return hi, tf32(a - hi)


def product(C: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """C [..., R, L] . b [..., L, P] from float32 operands split as the
    kernel splits them: 3 passes (lo.hi + hi.lo + hi.hi) or 1 (hi.hi).
    Each product of two TF32 values is exact in float64."""
    Ch, Cl = (t.double() for t in split(C.float()))
    bh, bl = (t.double() for t in split(b.float()))
    out = Ch @ bh
    if passes == 3:
        out = out + (Cl @ bh + Ch @ bl)
    return out


def contract_3xtf32(nu_grid, nu_c, sx, y, C1, C2, C3, C4, *, cutoff_cm1,
                    chi_b=None, passes=3) -> torch.Tensor:
    """The batched basis contraction [B, R, P] with the plain version's
    float32 basis and the kernel's split product."""
    basis = _basis(nu_grid.float(), nu_c.float(), sx.float(), y.float(),
                   None if chi_b is None else chi_b.float(),
                   cutoff_cm1=cutoff_cm1)
    out = sum(product(C, b, passes) for C, b in zip((C1, C2, C3, C4), basis))
    return out.to(nu_grid.dtype)


@pytest.fixture(scope="module")
def slice_like():
    """4 states x 64 lines x 512 points, R = 66 random rows scaled by the
    amplitudes (float32 numpy), and chi per line."""
    rng = np.random.default_rng(7)
    L, P, B, R = 64, 512, 4, 66
    dl = j_stage(random_lines(L, 600.0, 640.0, seed=0), [(2, 1)],
                 dtype=jnp.float32, nu_ref=0.0)
    kl = jop.line_kernel_inputs(dl, 220.0, 500.0, 50.0,
                                amp_weights=jnp.ones((2, L), jnp.float32))
    f32 = lambda a: np.asarray(a, np.float32)
    nc = f32([np.asarray(kl.nu_c) + 0.01 * b for b in range(B)])
    sx = f32([np.asarray(kl.scale_x) * (1 + 0.05 * b) for b in range(B)])
    y = f32([np.asarray(kl.y) * (1 + 0.1 * b) for b in range(B)])
    amps = np.asarray(kl.amps, np.float32)
    C = [f32(rng.normal(size=(B, R, L)) * amps[0]) for _ in range(4)]
    chi = f32(rng.uniform(0.0, 0.3, (B, L)))
    nu = np.linspace(605.0, 635.0, P).astype(np.float32)
    return nu, nc, sx, y, C, chi


@pytest.mark.parametrize("with_chi", [False, True])
def test_3xtf32_contraction_matches_pallas_interpret(slice_like, with_chi):
    nu, nc, sx, y, C, chi = slice_like
    chi = chi if with_chi else None
    j = jnp.asarray
    ref = np.asarray(basis_contract_pallas_batch_jit(
        j(nu), j(nc), j(sx), j(y), *(j(c) for c in C), cutoff_cm1=25.0,
        interpret=True, chi_b=None if chi is None else j(chi)))
    t = torch.as_tensor
    args = (t(nu), t(nc), t(sx), t(y), *(t(c) for c in C))
    kw = dict(cutoff_cm1=25.0, chi_b=None if chi is None else t(chi))
    got = contract_3xtf32(*args, **kw).numpy()
    one = contract_3xtf32(*args, passes=1, **kw).numpy()
    scale = np.abs(ref).max()
    err3 = np.abs(got - ref).max() / scale
    err1 = np.abs(one - ref).max() / scale
    print(f"\nR = 66, chi {with_chi}: max|err| / max|ref| 3xTF32 {err3:.3e}, "
          f"one-pass TF32 {err1:.3e} (budget {REL:g})")
    assert got.shape == ref.shape == (4, 66, 512)
    assert err3 <= REL


def _limb_pair():
    """A float32 limb scene with 33 levels in both packages: T [33] ->
    radiances (the reference's jnp engine; the port with the plain line
    sum and the emulated 3xTF32 contraction)."""
    atm = mars_standard_atmosphere(n_lev=33, z_top=80e3)
    atm = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), atm)
    dl = j_stage(co2_15um_band(j_max=16), [(2, 1)], dtype=jnp.float32)
    nu64 = np.linspace(620.0, 680.0, 160)
    ths = np.linspace(10e3, 60e3, 3)
    jf = jstate.build_forward(
        atm, dl, jnp.asarray(nu64, jnp.float32), ["CO2"], J_MARS,
        tangent_heights_m=jnp.asarray(ths, jnp.float32), n_sub=2,
        nu_off=jnp.asarray(nu64 - float(dl.nu_ref), jnp.float32),
        engine="jnp")
    tatm = interop.atmosphere_from_numpy(
        {**{k: np.asarray(getattr(atm, k)) for k in ("z", "p", "T", "n")},
         "vmr": {k: np.asarray(v) for k, v in atm.vmr.items()}}, device=CPU)
    tl = interop.device_lines_from_numpy(
        {k: np.asarray(v) for k, v in dl._asdict().items()}, device=CPU)

    def contract(nu_grid, windows, nu_c, sx, y, C1, C2, C3, C4, active=None,
                 **kw):
        return contract_3xtf32(nu_grid, nu_c, sx, y, C1, C2, C3, C4, **kw)

    engine = dataclasses.replace(cb.PLAIN, name="3xtf32", contract=contract)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    tf = tstate.build_forward(
        tatm, tl, f32(nu64), ["CO2"], MARS, tangent_heights_m=f32(ths),
        n_sub=2, nu_off=f32(nu64 - float(dl.nu_ref)), engine=engine)
    T0 = np.array(atm.T)
    return (lambda T: jf({"T": T, "ln_vmr": {}}),
            lambda T: tf({"T": T, "ln_vmr": {}}), T0)


def test_3xtf32_jacobian_matches_jax_jacfwd():
    jf, tf, T0 = _limb_pair()
    assert T0.shape == (33,)
    J_ref = np.asarray(jax.jacfwd(jf)(jnp.asarray(T0)))
    J = torch.func.jacfwd(tf)(torch.as_tensor(T0)).numpy()
    assert J.shape == J_ref.shape and np.isfinite(J).all()
    err = np.abs(J - J_ref).max() / np.abs(J_ref).max()
    print(f"\n33-column Jacobian, 3xTF32 contraction: max|err| / max|J| "
          f"{err:.3e} (budget {REL:g})")
    assert err <= REL


def test_tf32_rounds_to_nearest_even():
    """The emulated rounding: 10 mantissa bits kept, ties to even, and
    hi + lo within 2^-22 relative of the operand."""
    one = 1.0
    ulp = 2.0 ** -10
    a = torch.tensor([one, one + ulp / 2, one + 3 * ulp / 2,
                      one + ulp / 2 + 2.0 ** -20, -(one + ulp / 2)],
                     dtype=torch.float32)
    want = [one, one, one + 2 * ulp, one + ulp, -one]
    assert tf32(a).tolist() == want
    x = torch.as_tensor(np.random.default_rng(0).normal(size=4096),
                        dtype=torch.float32)
    hi, lo = split(x)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -22


def test_ablation_builds_apply_to_the_sources():
    """ablate_basis.py takes parts out of csrc/basis_contract.cuh by text
    edits: each edit applies to the source exactly once."""
    import ablate_basis
    from spectrobot_tpu_torch.kernels import build

    src = (build.SOURCE_DIR / ablate_basis.HEADER).read_text()
    assert set(ablate_basis.EDITS) >= {"full", "no_mma", "no_split"}
    for name, edits in ablate_basis.EDITS.items():
        for old, _ in edits:
            assert src.count(old) == 1, name

"""Bodies of the port's multi-rank tests (tests/test_torch_{collectives,
halo,sharded,mesh_retrieval,dma_halo,cia,composed,lut,weideman,
scaling,halo_overlap,spans}.py).  :func:`run`
starts ``world`` gloo ranks with ``torch.multiprocessing.spawn``; each runs
one case function of this module on numpy inputs made by the calling test
and saves what it returns.
This module imports torch and the port only (never jax), so the ranks start
light."""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CPU = torch.device("cpu")
# A deadlocked collective fails the test after this long instead of hanging.
TIMEOUT = timedelta(seconds=120)


def _entry(rank, world, tmp, case, args, join_group):
    torch.set_num_threads(1)
    if join_group:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        out = case(rank, world, *args)
    finally:
        if join_group:
            dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def run(tmp, world: int, case, *args, join_group: bool = True) -> list:
    """Run ``case(rank, world, *args)`` in ``world`` spawned ranks, joined
    in one gloo group (a file store under ``tmp``) unless ``join_group`` is
    False; returns what each rank returned, in rank order."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.spawn(_entry, args=(world, tmp, case, args, join_group),
             nprocs=world, join=True)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _mesh(shape):
    from spectrobot_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(shape, "cpu")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def collective_fn(x, A, mesh):
    """A function through all three collectives: psum over (ray, nu), a
    ring shift over nu and an all_gather over ray of l = sin(A_rank x)."""
    from spectrobot_tpu_torch.parallel import collectives as C
    r = (mesh.coord["ray"] * mesh.shape["line"] + mesh.coord["line"]) \
        * mesh.shape["nu"] + mesh.coord["nu"]
    loc = torch.sin(A[r] @ x)
    s = C.psum(loc * loc, mesh, ("ray", "nu"))
    sh = C.ring_shift(loc, mesh, "nu", 1)
    g = C.all_gather(loc, mesh, "ray", 0)
    return torch.cat([s, sh * s, g])


def collectives_case(rank, world, shape, A, x, ct, xs):
    mesh = _mesh(shape)
    A, x, ct, xs = (torch.as_tensor(a) for a in (A, x, ct, xs))
    f = lambda v: collective_fn(v, A, mesh)
    xr = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(torch.sum(ct[rank] * f(xr)), xr)
    return {"value": f(x), "jacfwd": torch.func.jacfwd(f)(x),
            "vjp": grad, "vmap": torch.func.vmap(f)(xs),
            "shift_twice": _shift_back_and_forth(x, mesh)}


def _shift_back_and_forth(x, mesh):
    from spectrobot_tpu_torch.parallel.collectives import ring_shift
    return ring_shift(ring_shift(x * (1 + mesh.coord["nu"]), mesh, "nu", 1),
                      mesh, "nu", -1)


# ---------------------------------------------------------------------------
# halo
# ---------------------------------------------------------------------------


def halo_case(rank, world, nu, nu0, kl, cutoff, edges, origins, kl32):
    """Each rank's block of the halo sums: plain (float64, with and without
    per-shard origins) and through K3's wrapper (float32)."""
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.parallel import halo
    mesh = _mesh((1, 1, world))
    k = mesh.coord["nu"]
    nu = torch.as_tensor(nu)
    nb = mesh.block(nu.shape[0], "nu")
    kl = KernelLines(*(torch.as_tensor(a) for a in kl))
    kl32 = KernelLines(*(torch.as_tensor(a) for a in kl32))
    out = {}
    skl = halo.partition_kernel_lines(kl, nu0, edges)
    out["plain"] = halo.halo_accumulate_fn(mesh, chunk=128, cutoff_cm1=cutoff)(
        nu[nb], halo.shard_lines(skl, k))
    skl_o = halo.partition_kernel_lines(kl, nu0, edges, origins=origins)
    nu_reb = halo.rebase_grid_per_shard(nu.numpy(), origins,
                                        dtype=torch.float64)
    out["origins"] = halo.halo_accumulate_fn(
        mesh, chunk=128, cutoff_cm1=cutoff, origins=origins)(
        nu_reb[nb], halo.shard_lines(skl_o, k))
    skl32 = halo.partition_kernel_lines(kl32, nu0, edges)
    f = halo.halo_accumulate_pallas_fn(mesh, nu.numpy(), skl32.nu_c.numpy(),
                                       cutoff_cm1=cutoff)
    out["kernel"] = f(nu[nb].float(), halo.shard_lines(skl32, k))
    return out


# ---------------------------------------------------------------------------
# the sharded forward
# ---------------------------------------------------------------------------


def _cia_nlte(sc):
    """The scene dict's continuum ("cia": DeviceCIA fields as numpy) and
    non-LTE state ("nlte": DeviceNLTE fields), or None for each."""
    from spectrobot_tpu_torch.data.nlte import DeviceNLTE
    from spectrobot_tpu_torch.ops.cia import DeviceCIA
    c, n = sc.get("cia"), sc.get("nlte")
    cia = None if c is None else DeviceCIA(
        torch.as_tensor(c["tables"]), torch.as_tensor(c["T_grid"]),
        tuple(c["pair_a"]), tuple(c["pair_b"]))
    nlte = None if n is None else DeviceNLTE(
        *(torch.as_tensor(n[k]) for k in DeviceNLTE._fields))
    return cia, nlte


def sharded_case(rank, world, cases):
    """Each case: (name, mesh shape, nu_halo, scene dict); returns each
    rank's [R_loc, P_loc] block and its mesh coordinates."""
    from spectrobot_tpu_torch import interop
    from spectrobot_tpu_torch.ops.planck import planck_nu
    from spectrobot_tpu_torch.parallel import sharded as sh
    out = {}
    for name, shape, nu_halo, sc in cases:
        mesh = _mesh(shape)
        nu = torch.as_tensor(sc["nu"])
        lines = interop.device_lines_from_numpy(sc["lines"], device=CPU)
        cg = interop.path_cg_from_numpy(sc["cg"], device=CPU)
        nu_off = torch.as_tensor(sc["nu"] - float(lines.nu_ref))
        if nu_halo:
            dlp = sh.partition_lines_by_nu(
                lines, sc["nu"], shape[2], cutoff_cm1=sc["cutoff"],
                line_shards=shape[1], round_to=sc.get("round_to", 128))
        else:
            dlp = sh.pad_lines_for_mesh(lines, shape[1])
        is_limb = sc["T_surface"] is None
        I_bg = (None if is_limb
                else sc["emissivity"] * planck_nu(nu, sc["T_surface"]))
        cia, nlte = _cia_nlte(sc)
        st = sh.stage_sharded(mesh, nu, dlp, cg, I_bg=I_bg, nu_off=nu_off,
                              nlte=nlte, cia=cia)
        f = sh.sharded_radiance_fn(
            mesh, win_grid=nu_off.numpy(), win_lines=dlp.nu0.numpy(),
            cutoff_cm1=sc["cutoff"], nu_halo=nu_halo, is_limb=is_limb,
            emissivity=sc["emissivity"])
        out[name] = (f(st.nu, st.nu_off, st.lines, st.cg, st.I_bg,
                       nlte=st.nlte, cia=st.cia),
                     dict(mesh.coord), tuple(dlp.nu0.shape))
    return out


# ---------------------------------------------------------------------------
# the early-issued halo exchange against the synchronous ring shift
# ---------------------------------------------------------------------------


def _parent_sharded(mesh, st, windows, cutoff, is_limb, emissivity):
    """The nu-halo sharded forward in the order of the synchronous shift:
    the own line sum, then per hop two ring shifts (reals, integers) and
    the hop's line sum, the line all-reduce and the epilogue."""
    from spectrobot_tpu_torch.forward.limb import (
        layer_tau_kernel, tau_radiance_epilogue)
    from spectrobot_tpu_torch.parallel import sharded as sh
    from spectrobot_tpu_torch.parallel.collectives import psum, ring_shift
    from spectrobot_tpu_torch.parallel.halo import _hops

    def tau(lines, s_i):
        return layer_tau_kernel(st.nu_off, lines, st.cg, windows[s_i],
                                cutoff_cm1=cutoff)

    def shifted(fields, shift):
        return ring_shift(torch.stack([getattr(st.lines, f) for f in fields]),
                          mesh, "nu", shift)

    dtau, dtau_em = tau(st.lines, 0)
    for shift, s_i in _hops(mesh.shape["nu"]):
        got = st.lines._replace(
            **dict(zip(sh._REAL_FIELDS, shifted(sh._REAL_FIELDS, shift))),
            **dict(zip(sh._INT_FIELDS, shifted(sh._INT_FIELDS, shift))))
        d2, d2e = tau(got, s_i)
        dtau, dtau_em = dtau + d2, dtau_em + d2e
    dtau, dtau_em = psum(torch.stack([dtau, dtau_em]), mesh, "line")
    return tau_radiance_epilogue(st.nu.to(dtau.dtype), st.cg, dtau, dtau_em,
                                 I_background=st.I_bg, is_limb=is_limb,
                                 emissivity=emissivity)


def _parent_halo(mesh, nu_loc, mine, cutoff, nu_host, skl_nu0):
    """halo_accumulate_fn and halo_accumulate_pallas_fn (K3's plain version
    here) in the order of the synchronous shift: the own sum, then per hop
    one ring shift of the packed lines and the hop's sum."""
    import numpy as np

    from spectrobot_tpu_torch.ops.cuda_opacity import line_windows
    from spectrobot_tpu_torch.ops.cuda_single import accumulate_single
    from spectrobot_tpu_torch.ops.opacity import accumulate_plain
    from spectrobot_tpu_torch.parallel import halo
    from spectrobot_tpu_torch.parallel.collectives import ring_shift
    n, k = mesh.shape["nu"], mesh.coord["nu"]
    hops = halo._hops(n)
    got = {s_i: halo.unpack_lines(ring_shift(halo.pack_lines(mine), mesh,
                                             "nu", shift))
           for shift, s_i in hops}
    plain = accumulate_plain(nu_loc, mine, chunk=256, cutoff_cm1=cutoff,
                             variant="humlicek4")
    for _, s_i in hops:
        d = torch.as_tensor(0.0, dtype=got[s_i].nu_c.dtype)
        plain = plain + accumulate_plain(
            nu_loc, got[s_i]._replace(nu_c=got[s_i].nu_c + d), chunk=256,
            cutoff_cm1=cutoff, variant="humlicek4")
    grid_k = np.asarray(nu_host, np.float64)[mesh.block(len(nu_host), "nu")]
    src = (k, (k - 1) % n, (k + 1) % n)

    def k3(kl, s_i):
        win = line_windows(grid_k, np.asarray(skl_nu0)[src[s_i]],
                           cutoff_cm1=cutoff, device=mesh.device)
        f32 = lambda a: a.to(torch.float32).contiguous()
        return accumulate_single(f32(nu_loc), win, f32(kl.nu_c),
                                 f32(kl.scale_x), f32(kl.y), f32(kl.amps),
                                 cutoff_cm1=cutoff)

    kernel = k3(mine, 0)
    for _, s_i in hops:
        kernel = kernel + k3(got[s_i], s_i)
    return plain, kernel


def exchange_case(rank, world, msgs, sharded_cases, halo_in, oe_cases):
    """On the (1, 1, world) mesh: ring_exchange_start/wait of this rank's
    messages ``msgs`` [rank] (reals, ints) at shifts 1, -1 and 2 beside
    ring_shift's; whether it refuses a jvp tangent, a vmap batch and a
    requires_grad input; the sharded forward of each (name, shape, scene)
    of ``sharded_cases`` and, on the (1, 1, world) mesh, in the order of
    the synchronous shift; the halo accumulations of ``halo_in`` (nu, nu0,
    kernel lines, cutoff) and in that order; each sharded forward and
    halo accumulation again, by the same function, on other line
    parameters ("sharded_again", "halo_again"); mesh_retrieval_case of
    ``oe_cases``."""
    from spectrobot_tpu_torch import interop
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.ops.planck import planck_nu
    from spectrobot_tpu_torch.parallel import collectives as C
    from spectrobot_tpu_torch.parallel import halo
    from spectrobot_tpu_torch.parallel import sharded as sh
    mesh = _mesh((1, 1, world))
    out = {}
    parts = [list(torch.as_tensor(m[rank])) for m in msgs]
    shifts = [1, -1, 2]
    got = C.ring_exchange_start(parts, mesh, "nu", shifts).wait()
    out["exchange"] = got
    out["ring_shift"] = [[C.ring_shift(torch.stack(p), mesh, "nu", s)
                          for p in parts] for s in shifts]
    x = torch.as_tensor(msgs[0][rank][0])

    def refuses(call):
        try:
            call()
        except ValueError as e:
            return "constants only" in str(e)
        return False

    start = lambda v: C.ring_exchange_start([[v]], mesh, "nu", [1])
    out["refuses"] = {
        "jvp": refuses(lambda: torch.func.jvp(
            lambda v: start(v).wait()[0][0], (x,), (torch.ones_like(x),))),
        "vmap": refuses(lambda: torch.func.vmap(
            lambda v: start(v).wait()[0][0])(x[None].repeat(3, 1))),
        "requires_grad": refuses(
            lambda: start(x.clone().requires_grad_()))}

    out["sharded"] = {}
    for name, shape, sc in sharded_cases:
        m = _mesh(shape)
        nu = torch.as_tensor(sc["nu"])
        lines = interop.device_lines_from_numpy(sc["lines"], device=CPU)
        cg = interop.path_cg_from_numpy(sc["cg"], device=CPU)
        nu_off = torch.as_tensor(sc["nu"] - float(lines.nu_ref))
        dlp = sh.partition_lines_by_nu(lines, sc["nu"], shape[2],
                                       cutoff_cm1=sc["cutoff"],
                                       line_shards=shape[1])
        is_limb = sc["T_surface"] is None
        I_bg = (None if is_limb
                else sc["emissivity"] * planck_nu(nu, sc["T_surface"]))
        st = sh.stage_sharded(m, nu, dlp, cg, I_bg=I_bg, nu_off=nu_off)
        f = sh.sharded_radiance_fn(
            m, win_grid=nu_off.numpy(), win_lines=dlp.nu0.numpy(),
            cutoff_cm1=sc["cutoff"], nu_halo=True, is_limb=is_limb,
            emissivity=sc["emissivity"])
        I = f(st.nu, st.nu_off, st.lines, st.cg, st.I_bg)
        windows = sh._rank_windows(m, nu_off.numpy(), dlp.nu0.numpy(), True,
                                   sc["cutoff"])
        out["sharded"][name] = (I, dict(m.coord), _parent_sharded(
            m, st, windows, sc["cutoff"], is_limb, sc["emissivity"]))
        # The same mesh function again on other line parameters: the
        # send buffer it keeps carries this forward's lines.
        st2 = st._replace(lines=st.lines._replace(
            sw=st.lines.sw * 1.5, gamma_air=st.lines.gamma_air * 0.8))
        out["sharded_again"] = out.get("sharded_again", {})
        out["sharded_again"][name] = (
            f(st2.nu, st2.nu_off, st2.lines, st2.cg, st2.I_bg),
            _parent_sharded(m, st2, windows, sc["cutoff"], is_limb,
                            sc["emissivity"]))

    nu, nu0, kl, cutoff = halo_in
    nu = torch.as_tensor(nu)
    kl = KernelLines(*(torch.as_tensor(a) for a in kl))
    edges = halo.nu_shard_edges(nu.numpy(), world, cutoff)
    skl = halo.partition_kernel_lines(kl, nu0, edges)
    mine = halo.shard_lines(skl, mesh.coord["nu"])
    nu_loc = nu[mesh.block(nu.shape[0], "nu")]
    plain_fn = halo.halo_accumulate_fn(mesh, cutoff_cm1=cutoff)
    kernel_fn = halo.halo_accumulate_pallas_fn(mesh, nu.numpy(),
                                               skl.nu_c.numpy(),
                                               cutoff_cm1=cutoff)
    out["halo"] = (
        plain_fn(nu_loc, mine), kernel_fn(nu_loc, mine),
        _parent_halo(mesh, nu_loc, mine, cutoff, nu.numpy(),
                     skl.nu_c.numpy()))
    mine2 = mine._replace(y=mine.y * 1.25, amps=mine.amps * 0.5)
    out["halo_again"] = (
        plain_fn(nu_loc, mine2), kernel_fn(nu_loc, mine2),
        _parent_halo(mesh, nu_loc, mine2, cutoff, nu.numpy(),
                     skl.nu_c.numpy()))
    out["oe"] = mesh_retrieval_case(rank, world, oe_cases)
    return out


# ---------------------------------------------------------------------------
# the sharded retrieval
# ---------------------------------------------------------------------------


def mesh_retrieval_case(rank, world, cases):
    """Each case: (name, mesh shape, kwargs of make_sharded_oe, scene dict,
    y, sigma); returns (forward, (F, H, g), K) of ShardedOE, and its row
    axes."""
    from spectrobot_tpu_torch import interop
    from spectrobot_tpu_torch.data.atmosphere import MARS
    from spectrobot_tpu_torch.parallel.oe import make_sharded_oe
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state
    out = {}
    for name, shape, kw, sc, y, sigma in cases:
        mesh = _mesh(shape)
        atm = interop.atmosphere_from_numpy(sc["atm"], device=CPU)
        lines = interop.device_lines_from_numpy(sc["lines"], device=CPU)
        t = lambda a: None if a is None else torch.as_tensor(a)
        state0 = make_state(atm, ["CO"])
        oe = make_sharded_oe(
            mesh, atm, lines, t(sc["nu"]), sc["species"], MARS,
            t(sc.get("h_t")), state_template=state0, ils_W=t(sc.get("W")),
            n_sub=2, sec_theta=t(sc.get("sec")),
            T_surface=sc.get("T_surface"), **kw)
        x0 = flatten_state(state0)[0]
        oe.bind_observation(y, sigma)
        out[name] = (oe.forward_flat(x0), oe.normal_eqs(x0),
                     oe.jacobian(x0), oe.row_axes)
    return out


# ---------------------------------------------------------------------------
# the (P, T) table tier
# ---------------------------------------------------------------------------


def lut_mesh_case(rank, world, sc, obs):
    """The lattice build shared over the ranks (an LTE and a non-LTE
    table), then on a (1, 1, world) and a (world, 1, 1) mesh the sharded
    table forward and make_sharded_oe(lut=)'s normal equations and
    Jacobian of the limb scene over T and ln VMR(CO)."""
    from spectrobot_tpu_torch import interop
    from spectrobot_tpu_torch.data.atmosphere import MARS
    from spectrobot_tpu_torch.ops import lut
    from spectrobot_tpu_torch.parallel.oe import make_sharded_oe
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state
    nu = torch.as_tensor(sc["nu"])
    lines = interop.device_lines_from_numpy(sc["lines"], device=CPU)
    atm = interop.atmosphere_from_numpy(sc["atm"], device=CPU)
    S = len(sc["species"])
    tbl = lut.build_lut(nu, lines, S, mesh=lut.lut_mesh(), **sc["lattice"])
    nl = lut.build_nlte_lut(nu, lines, S, mesh=lut.lut_mesh(),
                            **sc["lattice"])
    out = {"sigma": tbl.sigma, "sigma_l": nl.sigma_l, "sigma_u": nl.sigma_u,
           "sigma_e": nl.sigma_e}
    state0 = make_state(atm, ["CO"])
    x0 = flatten_state(state0)[0]
    for shape in ((1, 1, world), (world, 1, 1)):
        oe = make_sharded_oe(_mesh(shape), atm, lines, nu, sc["species"],
                             MARS, torch.as_tensor(sc["h_t"]),
                             state_template=state0, n_sub=2, lut=tbl)
        oe.bind_observation(*obs)
        out[shape] = (oe.forward_flat(x0), oe.normal_eqs(x0),
                      oe.jacobian(x0))
    return out


# ---------------------------------------------------------------------------
# the composed scene: non-LTE x CIA x FOV through the mesh
# ---------------------------------------------------------------------------


def composed_scene(n_lev=12, n_nu=2048, n_fine=6, j_max=10, *,
                   dtype=torch.float32, device=CPU):
    """The port's copy of the host part of the reference's composed
    feature-matrix scene (``__graft_entry__._composed_scene``): non-LTE
    (the CO2 4.3 um fundamental and hot band, nu3 pumped aloft) x a
    synthetic CO2-CO2 continuum x FOV tangent-height smearing, built with
    the port's modules.

    Returns (atm, dl, nlte, cia, nu, h_fine, fov_V, n_obs)."""
    import numpy as np

    from spectrobot_tpu_torch.data.atmosphere import mars_standard_atmosphere
    from spectrobot_tpu_torch.data.nlte import (
        device_nlte, lte_t_vib, match_lines_to_levels,
        registry_from_linelist)
    from spectrobot_tpu_torch.data.synth import (
        co2_43um_band, co2_43um_hot_band)
    from spectrobot_tpu_torch.ops.cia import CIATable, stage_cia
    from spectrobot_tpu_torch.ops.ils import fov_matrix
    from spectrobot_tpu_torch.ops.strengths import device_lines_from_linelist

    atm = mars_standard_atmosphere(n_lev=n_lev, z_top=100e3, device=device)
    ll = co2_43um_band(j_max=j_max).concat(co2_43um_hot_band(j_max=j_max - 2))
    reg = registry_from_linelist(ll)
    ll = match_lines_to_levels(ll, reg)
    dl = device_lines_from_linelist(ll, [(2, 1)], dtype=dtype, device=device)
    # nu3-pumped vibrational stack above ~50 km (prescribed populations).
    z_lev = atm.z.cpu().numpy()
    z_mid = 0.5 * (z_lev[1:] + z_lev[:-1])
    T_lay = np.interp(z_mid, z_lev, atm.T.cpu().numpy())
    t_vib = lte_t_vib(reg, T_lay)
    boost = 1.0 + 0.3 * np.clip((z_mid - 50e3) / 40e3, 0.0, 1.0)
    for i, (m, iso, q) in enumerate(reg.keys):
        if q in ("0001", "0111"):
            t_vib[i] = T_lay * boost
    nlte = device_nlte(reg, t_vib, dtype=dtype, device=device)
    nu = torch.as_tensor(np.linspace(2320.0, 2360.0, n_nu), dtype=dtype,
                         device=device)
    # A synthetic continuum with support in band, sized to be a visible
    # radiance term on the low rays (test data).
    nu_t = np.linspace(2250.0, 2450.0, 201)
    T_t = np.array([120.0, 180.0, 240.0, 300.0])
    k_t = (4e-44 * np.exp(-0.5 * ((nu_t - 2340.0) / 30.0) ** 2)[None, :]
           * (200.0 / T_t[:, None]))
    cia = stage_cia(nu, [CIATable("CO2", "CO2", nu_t, T_t, k_t)], ["CO2"],
                    dtype=dtype, device=device)
    # FOV: a fine tangent ladder smeared into fewer observed rays.
    h_fine = np.linspace(15e3, 70e3, n_fine)
    h_obs = np.array([28e3, 55e3])
    fov_V = torch.as_tensor(fov_matrix(h_fine, h_obs, fwhm_m=8e3),
                            dtype=dtype, device=device)
    return (atm, dl, nlte, cia, nu,
            torch.as_tensor(h_fine, dtype=dtype, device=device), fov_V,
            len(h_obs))


COMPOSED = dict(n_sub=2, cutoff_cm1=8.0)


def composed_case(rank, world, shape, scene_kw, y_obs, sigma, x0, S_a,
                  max_iter):
    """make_sharded_oe on the composed scene (float64) in the nu-halo tier:
    its forward and Jacobian at the truth (the atmosphere's state), and
    the LM retrieval of ``y_obs`` from ``x0``."""
    import numpy as np

    from spectrobot_tpu_torch.data.atmosphere import MARS
    from spectrobot_tpu_torch.parallel.oe import make_sharded_oe
    from spectrobot_tpu_torch.retrieval.oe import OEConfig, retrieve
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state
    mesh = _mesh(shape)
    atm, dl, nlte, cia, nu, h_fine, fov_V, _ = composed_scene(
        **scene_kw, dtype=torch.float64)
    state0 = make_state(atm, [])
    oe = make_sharded_oe(mesh, atm, dl, nu, ["CO2"], MARS, h_fine,
                         state_template=state0, fov_V=fov_V, nlte=nlte,
                         cia=cia, nu_halo=True, **COMPOSED)
    x_true = flatten_state(state0)[0]
    out = {"y": oe.forward_flat(x_true), "K": oe.jacobian(x_true),
           "row_axes": oe.row_axes}
    oe.bind_observation(y_obs, sigma)
    x0 = torch.as_tensor(np.asarray(x0))
    res = retrieve(oe.forward_flat, oe.jacobian, y_obs, x0, x0, S_a, sigma,
                   OEConfig(max_iter=max_iter), normal_eqs=oe.normal_eqs)
    out["res"] = (res.x, bool(res.converged), res.history)
    return out


def cli_case(rank, world, toml, runs):
    """``cli.main`` in each rank with torchrun's environment, once per run
    (argv, port): a new rendezvous port for each process group."""
    from spectrobot_tpu_torch import cli
    for argv, port in runs:
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
        assert cli.main([argv[0], toml, "--device", "cpu", *argv[1:]]) == 0
    return None


def weideman_halo_case(rank, world, toml):
    """The CLI's scene of ``toml`` (compute.variant = "weideman", the
    nu-halo tier) on a (1, 1, world) mesh: the sharded forward and
    temperature Jacobian at the prior through the engine ``select_engine``
    gives, and that engine's name."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.config import load_config
    from spectrobot_tpu_torch.retrieval.state import flatten_state, make_state
    cfg = load_config(toml)
    engine = cli.select_engine(cfg, CPU)
    scene = cli.build_scene(cfg, CPU)
    atm = scene.atm.to(scene.nu.dtype)
    state = make_state(atm, [])
    oe = cli.sharded_problem(cfg, scene, _mesh((1, 1, world)), atm, state,
                             engine)
    x0 = flatten_state(state)[0]
    return oe.forward_flat(x0), oe.jacobian(x0), engine.name


# ---------------------------------------------------------------------------
# the remote-copy halo tier (its plain versions on gloo ranks)
# ---------------------------------------------------------------------------


def dma_case(rank, world, ring_xs, halo_skl, fused):
    """Each rank's results of spectrobot_tpu_torch.dma_halo's entry points
    on the (1, 1, world) mesh: the ring exchange of its block of each
    [world * rows, cols] array of ``ring_xs`` in both directions,
    ring_halo_lines of its row of ``halo_skl`` (or None), the fused halo sum
    of its grid chunk (``fused`` = (nu, skl, cutoff)), and the ring's epoch
    (calls made)."""
    from spectrobot_tpu_torch import dma_halo
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.parallel.peer import mesh_ring
    mesh = _mesh((1, 1, world))

    def mine(skl):
        return KernelLines(*(torch.as_tensor(a)[rank] for a in skl))

    out = {"ring": {}}
    for key, x in ring_xs.items():
        blk = torch.as_tensor(x).reshape(world, -1, x.shape[1])[rank]
        for d in (1, -1):
            out["ring"][key, d] = dma_halo.ring_exchange(mesh, "nu", d)(blk)
    if halo_skl is not None:
        out["halo_lines"] = dma_halo.ring_halo_lines(mesh, mine(halo_skl))
    nu, skl, cutoff = fused
    nu_loc = torch.as_tensor(nu)[mesh.block(len(nu), "nu")]
    out["fused"] = dma_halo.fused_halo_accumulate_fn(
        mesh, cutoff_cm1=cutoff)(nu_loc, mine(skl))
    out["epoch"] = mesh_ring(mesh).epoch
    return out


def scaling_case(rank, world, n_points, n_lines, n_rays):
    """Each rank's block of spectrobot_tpu_torch.scaling's mesh forward on
    the (1, 1, world) mesh over ``n_points`` points, float64, in the psum
    and the nu-halo tier."""
    from spectrobot_tpu_torch import scaling
    mesh = _mesh((1, 1, world))
    dl, cg = scaling.scene(CPU, torch.float64, n_lines, n_rays)
    return {halo: scaling.mesh_forward(mesh, dl, cg, n_points, halo)()
            for halo in (False, True)}


def mesh_ranges_case(rank, world, n_points, n_lines, n_rays):
    """One nu-halo mesh forward of the scaling tool's scene (float64) on
    the (1, 1, world) mesh under ``torch.profiler``: the names of the
    profiler's events and of the span records (``utils.profiling``)."""
    from torch.profiler import ProfilerActivity, profile

    from spectrobot_tpu_torch import scaling
    from spectrobot_tpu_torch.utils import profiling
    mesh = _mesh((1, 1, world))
    dl, cg = scaling.scene(CPU, torch.float64, n_lines, n_rays)
    fwd = scaling.mesh_forward(mesh, dl, cg, n_points, True)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fwd()
    return ({e.name for e in prof.events()},
            [r["name"] for r in profiling.spans()])


# ---------------------------------------------------------------------------
# the graph route of the mesh bodies (parallel.graphed)
# ---------------------------------------------------------------------------

# The ATen calls that read a tensor's values on the host: each would stop a
# CUDA graph's capture of the mesh body on the card.
HOST_READS = ("aten::_local_scalar_dense", "aten::nonzero",
              "aten::masked_select", "aten::is_nonzero", "aten::equal",
              "aten::_unique2", "aten::unique_consecutive")


def _host_reads_mode(names=HOST_READS):
    """A dispatch mode that records the calls of ``names`` (by default
    HOST_READS) made under it (``.seen``); the kernels' plain versions run
    outside it (on the card the kernels run in their place)."""
    from torch.utils._python_dispatch import (
        TorchDispatchMode, _disable_current_modes)

    from spectrobot_tpu_torch.ops import cuda_opacity, cuda_single

    class HostReads(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []
            self._saved = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._schema.name in names:
                self.seen.append(func._schema.name)
            return func(*args, **(kwargs or {}))

        def __enter__(self):
            for mod, name in ((cuda_opacity, "accumulate_batch_plain"),
                              (cuda_single, "accumulate_single_plain")):
                plain = getattr(mod, name)

                def outside(*a, _plain=plain, **kw):
                    with _disable_current_modes():
                        return _plain(*a, **kw)
                self._saved.append((mod, name, plain))
                setattr(mod, name, outside)
            return super().__enter__()

        def __exit__(self, *exc):
            for mod, name, plain in self._saved:
                setattr(mod, name, plain)
            return super().__exit__(*exc)

    return HostReads()


def graph_route_case(rank, world, toml, overrides):
    """The mesh bodies of the CLI scene of ``toml`` (with ``overrides``:
    non-LTE and the continuum) on the (1, 1, world) mesh (nu-halo tier:
    the limb, and nadir over a grey surface) and the (1, world, 1) mesh
    (psum tier, limb), and the K3 halo accumulation of random lines:
    "reads", the HOST_READS each body makes (``_host_reads_mode``);
    "probe", what the mode records of a host read; "cpu_route", for each
    body called twice through its GraphedBody with ``torch.cuda.graph``
    and ``torch.cuda.CUDAGraph`` made to raise: (graphs captured, replays,
    both calls bit-equal to the eager body)."""
    import numpy as np

    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.forward.geometry import (
        limb_path_cg, nadir_path_cg)
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.ops.planck import planck_nu
    from spectrobot_tpu_torch.parallel import halo
    from spectrobot_tpu_torch.parallel import sharded as sh

    cfg = cli.load_config(toml, overrides)
    scene = cli.build_scene(cfg, CPU)
    atm = scene.atm.to(scene.nu.dtype)
    cut, n_sub = cfg.compute.cutoff_cm1, cfg.geometry.n_sub
    nu_host = scene.nu.double().numpy()
    nu_off = scene.nu_off.double().numpy()
    limb = limb_path_cg(atm, scene.species_names, scene.h_t, scene.planet,
                        n_sub)
    nadir = nadir_path_cg(atm, scene.species_names, torch.as_tensor(
        [1.0, 1.5], dtype=scene.nu.dtype), n_sub)
    bg = 0.9 * planck_nu(scene.nu, torch.as_tensor(230.0,
                                                   dtype=scene.nu.dtype))
    calls = {}
    for name, shape, halo_on, cg, I_bg in (
            ("halo limb", (1, 1, world), True, limb, None),
            ("halo nadir", (1, 1, world), True, nadir, bg),
            ("psum limb", (1, world, 1), False, limb, None)):
        mesh = _mesh(shape)
        lines = (sh.partition_lines_by_nu(scene.lines, nu_host, world,
                                          cutoff_cm1=cut)
                 if halo_on else sh.pad_lines_for_mesh(scene.lines, world))
        f = sh.sharded_radiance_fn(
            mesh, win_grid=nu_off, win_lines=lines.nu0.double().numpy(),
            cutoff_cm1=cut, nu_halo=halo_on, is_limb=I_bg is None,
            emissivity=1.0 if I_bg is None else 0.9)
        st = sh.stage_sharded(mesh, scene.nu, lines, cg, I_bg=I_bg,
                              nu_off=scene.nu_off, nlte=scene.nlte,
                              cia=scene.cia)
        calls[name] = (f, (st.nu, st.nu_off, st.lines, st.cg, st.I_bg),
                       {"nlte": st.nlte, "cia": st.cia})

    rng = np.random.default_rng(7)
    L, cutoff = 96, 10.0
    nu = torch.linspace(600.0, 700.0, 512, dtype=torch.float64)
    nu0 = np.sort(rng.uniform(600.0, 700.0, L))
    kl = KernelLines(torch.as_tensor(nu0), torch.as_tensor(
        rng.uniform(5.0, 20.0, L)), torch.as_tensor(rng.uniform(0.1, 2.0, L)),
        torch.as_tensor(rng.uniform(0.5, 1.0, (2, L))))
    mesh = _mesh((1, 1, world))
    skl = halo.partition_kernel_lines(
        kl, nu0, halo.nu_shard_edges(nu.numpy(), world, cutoff))
    k3 = halo.halo_accumulate_pallas_fn(mesh, nu.numpy(), skl.nu_c.numpy(),
                                        cutoff_cm1=cutoff)
    calls["K3 halo"] = (k3, (nu[mesh.block(nu.shape[0], "nu")],
                             halo.shard_lines(skl, mesh.coord["nu"])), {})

    out = {"reads": {}, "cpu_route": {}}
    for name, (f, args, kwargs) in calls.items():
        with _host_reads_mode() as mode:
            f.body(*args, **kwargs)
        out["reads"][name] = mode.seen
    with _host_reads_mode() as mode:
        int(torch.zeros((), dtype=torch.int64))
    out["probe"] = mode.seen

    def refuse(*a, **kw):
        raise AssertionError("a CPU call reached torch.cuda's graphs")

    saved = torch.cuda.graph, torch.cuda.CUDAGraph
    torch.cuda.graph = torch.cuda.CUDAGraph = refuse
    try:
        for name, (f, args, kwargs) in calls.items():
            got = [f(*args, **kwargs) for _ in range(2)]
            eager = f.body(*args, **kwargs)
            out["cpu_route"][name] = (len(f.graphs), f.replays,
                                      all(torch.equal(g, eager) for g in got))
    finally:
        torch.cuda.graph, torch.cuda.CUDAGraph = saved
    return out


class EagerCapture:
    """A stand-in for ``parallel.graphed._Graph`` on the CPU: keeps the
    body and the capture's inputs (``made``: every one made), and replays
    by running the body eagerly on the replay's inputs."""
    made = []

    def __init__(self, body, leaves, spec, spans=False):
        from torch.utils._pytree import tree_unflatten
        self.body, self.leaves, self.spec = body, leaves, spec
        self.unflatten, self.pool_bytes = tree_unflatten, 0
        self.graph = type("G", (), {"reset": lambda s: None})()
        EagerCapture.made.append(self)

    def replay(self, tensors):
        new = iter(tensors)
        leaves = [next(new) if isinstance(t, torch.Tensor) else t
                  for t in self.leaves]
        args, kwargs = self.unflatten(leaves, self.spec)
        return self.body(*args, **kwargs)


def jacobian_route_mesh_case(rank, world, toml, out_dir, port):
    """The CLI's retrieve of ``toml`` on the (1, 1, world) mesh, the graph
    route forced as on the card and the capture an ``EagerCapture``:
    (the single-card Jacobian's graph counts after it, the captures the
    mesh's own bodies made)."""
    from spectrobot_tpu_torch import cli
    from spectrobot_tpu_torch.parallel import graphed
    from spectrobot_tpu_torch.retrieval.state import GRAPH_COUNTS
    graphed.graph_route = graphed.constant_call
    graphed._Graph = EagerCapture
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    assert cli.main(["retrieve", toml, "--device", "cpu", "-o",
                     f"compute.mesh_nu={world}", "-o",
                     f"run.output_dir={out_dir}"]) == 0
    return dict(GRAPH_COUNTS), len(EagerCapture.made)


def graph_card_case(rank, world, tmp, shapes):
    """On the card (NCCL, one card a rank, a file store under ``tmp``): for
    each mesh shape of ``shapes`` and each tier, the slice
    (``halo_overlap.make_scene("slice")``, cutoff 10 cm-1) through its
    GraphedBody on two PathCG states in turn (A: first call, eager then
    captured; then B, A, B, A replayed), each call against the eager body
    on the same inputs; the launches of every call, and of the first
    replay as its profiler trace shows them; the mesh Jacobian
    (``torch.func.jacfwd`` over a column scale) through the GraphedBody
    and through the body, and the graphs and replays before and after it;
    then the K3 halo accumulation of random lines alike on two amplitude
    sets.  Returns {name: record}."""
    import numpy as np

    from spectrobot_tpu_torch import halo_overlap as ho
    from spectrobot_tpu_torch.kernels.launch import LAUNCHES
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.parallel import halo
    from spectrobot_tpu_torch.parallel import sharded as sh
    from spectrobot_tpu_torch.parallel.mesh import (
        finalize_multihost, make_mesh)

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False

    def turns(f, calls):
        """(bit-equal to the body, launches) of every call, in turn, and
        the launches the first replay's profiler trace shows."""
        rec = []
        for j, i in enumerate((0, 1, 0, 1, 0)):
            before = LAUNCHES.copy()
            if j == 1:
                seen, got = ho.traced_launches(lambda: calls[i](f), dev)
                traced = {k: n for k, n in seen.items() if n}
            else:
                got = calls[i](f)
            torch.cuda.synchronize()
            after = LAUNCHES.copy()
            rec.append((bool(torch.equal(got, calls[i](f.body))),
                        {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}))
        return {"calls": rec, "traced": traced, "graphs": len(f.graphs),
                "replays": f.replays,
                "pool_bytes": sum(g.pool_bytes for g in f.graphs.values())}

    out = {}
    try:
        sc = ho.make_scene("slice", dev, world)
        nu_off = sc.nu_host - float(sc.lines.nu_ref)
        t = lambda a: torch.as_tensor(a, dtype=sc.cg.u.dtype, device=dev)
        cgs = (sc.cg, sc.cg._replace(T_sp=sc.cg.T_sp * 1.02,
                                     T_air=sc.cg.T_air * 1.02,
                                     u=sc.cg.u * 0.9))
        for shape in shapes:
            mesh = make_mesh(shape, "cuda")
            for tier, halo_on in (("psum", False), ("nu-halo", True)):
                lines = (sh.partition_lines_by_nu(
                    sc.lines, sc.nu_host, shape[2], cutoff_cm1=sc.cutoff_cm1,
                    line_shards=shape[1]) if halo_on
                    else sh.pad_lines_for_mesh(sc.lines, shape[1]))
                f = sh.sharded_radiance_fn(
                    mesh, win_grid=nu_off,
                    win_lines=lines.nu0.cpu().double().numpy(),
                    cutoff_cm1=sc.cutoff_cm1, nu_halo=halo_on)
                sts = [sh.stage_sharded(mesh, t(sc.nu_host), lines, cg,
                                        nu_off=t(nu_off)) for cg in cgs]
                calls = [(lambda st: lambda g: g(st.nu, st.nu_off, st.lines,
                                                 st.cg))(st) for st in sts]
                rec = turns(f, calls)
                st = sts[0]

                def jac(g):
                    return torch.func.jacfwd(lambda s: g(
                        st.nu, st.nu_off, st.lines,
                        st.cg._replace(u=st.cg.u * s)))(
                        torch.ones(1, dtype=st.cg.u.dtype, device=dev))
                seen = (len(f.graphs), f.replays)
                J = jac(f)
                rec["jacobian"] = {
                    "equal_to_body": bool(torch.equal(J, jac(f.body))),
                    "graphs_replays": (seen, (len(f.graphs), f.replays)),
                    "finite": bool(torch.isfinite(J).all())}
                out[f"{tier} {tuple(shape)}"] = rec

        rng = np.random.default_rng(7)
        L, cutoff = 2048, 10.0
        nu = torch.linspace(600.0, 700.0, 4096 * world, dtype=torch.float64)
        nu0 = np.sort(rng.uniform(600.0, 700.0, L))
        kl = KernelLines(torch.as_tensor(nu0), torch.as_tensor(
            rng.uniform(5.0, 20.0, L)), torch.as_tensor(
            rng.uniform(0.1, 2.0, L)), torch.as_tensor(
            rng.uniform(0.5, 1.0, (2, L))))
        mesh = make_mesh((1, 1, world), "cuda")
        skl = halo.partition_kernel_lines(
            kl, nu0, halo.nu_shard_edges(nu.numpy(), world, cutoff),
            out_dtype=torch.float32)
        skl = skl._replace(**{k: v.to(dev) for k, v in skl._asdict().items()})
        f = halo.halo_accumulate_pallas_fn(mesh, nu.numpy(),
                                           skl.nu_c.cpu().numpy(),
                                           cutoff_cm1=cutoff)
        nu_loc = nu[mesh.block(nu.shape[0], "nu")].float().to(dev)
        mine = halo.shard_lines(skl, mesh.coord["nu"])
        mine2 = mine._replace(amps=mine.amps * 0.5, y=mine.y * 1.25)
        out["K3 halo"] = turns(f, [(lambda m: lambda g: g(nu_loc, m))(m)
                                   for m in (mine, mine2)])
    finally:
        finalize_multihost()
    return out


# ---------------------------------------------------------------------------
# the capture ring (the transport of a captured exchange)
# ---------------------------------------------------------------------------


def _own(hops):
    """Received messages, each a tensor of its own (a packed exchange's are
    views of one buffer in several dtypes, which torch.save refuses)."""
    return [[t.clone() for t in msgs] for msgs in hops]


def capture_ring_case(rank, world, msgs, shapes):
    """For each mesh shape of ``shapes``: the capture ring's ranks, size and
    flags beside the ``nu`` group's ranks; this rank's messages ``msgs``
    [rank] through ``collectives.capture_exchange`` over the ring (its
    plain version on the CPU), through the eager ``ring_exchange_start``
    and through ``ring_shift``, at the halo's shifts; then, with
    ``capture_exchange`` recording its calls: the calls that the eager
    mesh bodies (the nu-halo forward of ``halo_overlap``'s aot scene and
    its ``jacfwd``, the K3 halo accumulation), ``ring_shift`` and the eager
    exchange made ("eager", expected none), and the exchange issued with a
    stream while ``torch.cuda.is_current_stream_capturing`` says True
    ("captured": its calls and received messages), and whether such an
    exchange on another axis is refused."""
    import numpy as np

    from spectrobot_tpu_torch import halo_overlap as ho
    from spectrobot_tpu_torch.kernels.launch import LAUNCHES
    from spectrobot_tpu_torch.ops.opacity import KernelLines
    from spectrobot_tpu_torch.parallel import collectives as C
    from spectrobot_tpu_torch.parallel import halo
    from spectrobot_tpu_torch.parallel import sharded as sh

    out = {"rings": {}, "exchange": {}}
    parts = [list(torch.as_tensor(m[rank])) for m in msgs]
    for shape in shapes:
        mesh = _mesh(shape)
        ring = mesh.capture_ring
        out["rings"][shape] = {
            "ranks": ring.ranks,
            "nu_ranks": dist.get_process_group_ranks(mesh.groups["nu"]),
            "n": ring.n, "on_device": ring.on_device,
            "loopback": ring.loopback, "mesh_is_its": ring.mesh is mesh}
        shifts = [s for s, _ in halo._hops(mesh.shape["nu"])]
        sends = [torch.stack(p) for p in parts]
        out["exchange"][shape] = {
            "shifts": shifts,
            "capture": _own(C.capture_exchange(sends, ring, shifts).wait()),
            "eager": C.ring_exchange_start(parts, mesh, "nu", shifts).wait(),
            "ring_shift": [[C.ring_shift(x, mesh, "nu", s) for x in sends]
                           for s in shifts],
            "workspace": ring.workspace}

    # The eager bodies: the nu-halo forward of the aot scene on (1, w/2, 2)
    # and its jacfwd over a column scale, and the K3 halo accumulation of
    # random lines on (1, 1, w).
    sc = ho.make_scene("aot", CPU, world)
    aot = _mesh((1, world // 2, 2))
    dlp = sh.partition_lines_by_nu(sc.lines, sc.nu_host, 2,
                                   cutoff_cm1=sc.cutoff_cm1,
                                   line_shards=world // 2)
    nu_off = sc.nu_host - float(sc.lines.nu_ref)
    fwd = sh.sharded_radiance_fn(aot, win_grid=nu_off,
                                 win_lines=dlp.nu0.double().numpy(),
                                 cutoff_cm1=sc.cutoff_cm1, nu_halo=True)
    st = sh.stage_sharded(aot, torch.as_tensor(sc.nu_host), dlp, sc.cg,
                          nu_off=torch.as_tensor(nu_off))
    rng = np.random.default_rng(7)
    L, cutoff = 96, 10.0
    nu = torch.linspace(600.0, 700.0, 512, dtype=torch.float64)
    nu0 = np.sort(rng.uniform(600.0, 700.0, L))
    kl = KernelLines(torch.as_tensor(nu0), torch.as_tensor(
        rng.uniform(5.0, 20.0, L)), torch.as_tensor(rng.uniform(0.1, 2.0, L)),
        torch.as_tensor(rng.uniform(0.5, 1.0, (2, L))))
    mesh = _mesh((1, 1, world))
    skl = halo.partition_kernel_lines(
        kl, nu0, halo.nu_shard_edges(nu.numpy(), world, cutoff))
    k3 = halo.halo_accumulate_pallas_fn(mesh, nu.numpy(), skl.nu_c.numpy(),
                                        cutoff_cm1=cutoff)
    calls = []
    real = C.capture_exchange

    def record(sends, ring, shifts, stream=None):
        calls.append((ring is mesh.capture_ring, list(shifts),
                      stream is not None))
        return real(sends, ring, shifts)

    C.capture_exchange = record
    try:
        fwd(st.nu, st.nu_off, st.lines, st.cg)
        torch.func.jacfwd(lambda s: fwd(
            st.nu, st.nu_off, st.lines, st.cg._replace(u=st.cg.u * s)))(
            torch.ones(1, dtype=st.cg.u.dtype))
        k3(nu[mesh.block(nu.shape[0], "nu")],
           halo.shard_lines(skl, mesh.coord["nu"]))
        C.ring_shift(torch.stack(parts[0]), mesh, "nu", 1)
        C.ring_exchange_start(parts, mesh, "nu", [1, -1]).wait()
        out["eager"] = list(calls)
        del calls[:]
        capturing = torch.cuda.is_current_stream_capturing
        torch.cuda.is_current_stream_capturing = lambda: True
        try:
            got = C.ring_exchange_start(parts, mesh, "nu", [1, -1],
                                        stream=object()).wait()
            try:
                C.ring_exchange_start(parts, mesh, "line", [1],
                                      stream=object())
                refused = False
            except ValueError:
                refused = True
        finally:
            torch.cuda.is_current_stream_capturing = capturing
        out["captured"] = (list(calls), _own(got), refused)
    finally:
        C.capture_exchange = real
    return out

"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with its wall time against its budget:

1. device  -- the card's name and power limit; no card exits non-zero.
2. build   -- a fresh ase_tpu_torch/_build/, nvcc of every CUDA source with
              -Xptxas -v (registers, stack, spills of every kernel instance
              printed; the engine's n=37 instances of chol_forward and
              back_solve must use no stack), and both kernels' launch
              shape and occupancy (at n=37 at least 32 warps per SM for
              chol_forward, 8 for back_solve).
3. kernels -- every kernel of the player path held against its plain
              PyTorch version on the card at four sizes (the engine's
              n=37, m=72, m2=1, B=4096; the factor-dominated m=1 at
              B=4096; a ragged B=129; n=8), with its
              device time, its bound, the plain version's device time and a
              library yardstick's (CUDA events around a CUDA graph of 20
              calls, so host work in a wrapper cannot enter a time). These
              calls reuse one input set, which stays in the 50 MB L2 when
              it is small (``ms``, warm); ``cold_ms`` times the kernels at
              the engine's shape, and back_solve at every size, on calls
              that rotate over copies of the inputs holding more than
              COLD_BYTES, so each call finds L2 cold, as in the engine,
              where other work runs between the calls.
4. player  -- ``ase_tpu_torch.run``'s player on HumanoidAMPGetup with the
              shipped ASE LLC at 4096 envs for one chunk of STEPS control
              steps. The kernel launch counters are zeroed just before and
              read just after; obs, actions and rewards must be finite.
5. profile -- one more control step under torch.profiler: device-busy
              share, kernel launches per step and the kernels that take the
              most device time (printed; "not measured" if the profiler
              records no device time).
6. check   -- one engine tick on 8 of those envs, on the card (kernels) and
              on the CPU (plain versions), must agree within the tolerances
              of ``check_tick`` (shared with tests/test_torch_cuda.py).

Any failure exits non-zero. The last two lines are the kernels JSON and the
result JSON ``{"ok": true, "device": {...}}``.
"""

import itertools
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

STEPS = 16
FALL_LAUNCHES = 150 * 2          # fall-state drop: 150 ticks x 2 substeps
TOTAL_BUDGET_S = 570
BUDGET_S = {"device": 60, "build": 120, "kernels": 120, "player": 360, "profile": 60,
            "check": 60}
REPO = os.path.dirname(os.path.abspath(__file__))
PLAYER_ARGV = [
    "--test", "--task", "HumanoidAMPGetup",
    "--cfg_env", "humanoid_ase_sword_shield_getup.yaml",
    "--cfg_train", "train/rlg/ase_humanoid.yaml",
    "--motion_file", "data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml",
    "--checkpoint", "data/models/ase_llc_reallusion_sword_shield.ckpt.npz",
    "--num_envs", "4096",
]
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # float32 outside the tensor cores
COLD_BYTES = 100e6               # twice the H100's 50 MB L2
TOL = 1e-4                       # relative to the largest plain-version magnitude
TICK_POS_TOL = 5e-5              # one tick, card vs CPU: positions and rotations, absolute
TICK_VEL_RTOL = 1e-4             # ... velocities, relative to their largest magnitude


class Failed(Exception):
    pass


def _timeout(signum, frame):
    raise Failed(f"total time budget of {TOTAL_BUDGET_S} s exceeded")


def phase(name, fn, t_start):
    t0 = time.time()
    out = fn()
    dt = time.time() - t0
    print(f"phase {name}: {dt:.1f} s (budget {BUDGET_S[name]} s, total {time.time() - t_start:.1f} s)",
          flush=True)
    if dt > BUDGET_S[name]:
        raise Failed(f"phase {name} took {dt:.1f} s, over its {BUDGET_S[name]} s budget")
    return out


_side = None


def cuda_ms(torch, fn, reps=20):
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed between two CUDA events after a warm-up, so host work in
    a wrapper (checks, allocation, the ctypes call) never enters the time."""
    global _side
    if _side is None:   # one capture stream for every timing: one cuBLAS workspace
        _side = torch.cuda.Stream()
    _side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(_side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(_side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=_side):
        for _ in range(reps):
            fn()
    graph.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def cold_ms(torch, fn, args, work_bytes):
    """Device time of one call of ``fn(*args)`` as a caller finds it whose
    other work has evicted the inputs from L2: the captured calls rotate
    over copies of ``args``, so many that the bytes the calls move
    (``work_bytes`` each) exceed COLD_BYTES, and every copy is used once
    per replay before any is used again."""
    sets = max(2, math.ceil(COLD_BYTES / work_bytes))
    copies = itertools.cycle([tuple(a.clone() for a in args) for _ in range(sets)])
    return cuda_ms(torch, lambda: fn(*next(copies)), max(20, sets))


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise Failed("torch.cuda.is_available() is false: this smoke test needs the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    sys.path.insert(0, REPO)
    import ase_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card, name


def _ptxas_report(text):
    """{kernel: (stack/spill line, registers line)} from ``-Xptxas -v`` output,
    with the template instances named as in the source."""
    import re

    def pretty(sym):
        k = re.search(r"(chol_forward_kernel|back_solve_kernel)(?:ILi(\d+)EE)?", sym)
        if k is None:
            return sym
        return k.group(1) + (f"<{k.group(2)}>" if k.group(2) is not None else "")

    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w]+)", line)
        if m:
            cur = pretty(m.group(1))
            out.setdefault(cur, ["", ""])
        elif cur and "stack frame" in line:
            out[cur][0] = line.strip()
        elif cur and "Used" in line:
            out[cur][1] = line.split(":", 1)[-1].strip()
    return out


def build_phase():
    import ctypes

    import torch
    from ase_tpu_torch.ops import chol, cuda_build

    shutil.rmtree(cuda_build.BUILD_DIR, ignore_errors=True)
    os.makedirs(cuda_build.BUILD_DIR)
    report = {}
    for name, (path, text) in cuda_build.build(list(cuda_build.SOURCES), verbose=True).items():
        print(f"built {name}: {os.path.relpath(path, REPO)}")
        for kernel, (stack, used) in _ptxas_report(text).items():
            print(f"  {kernel}: {stack}; {used}")
            report[kernel] = stack
    for kernel in ("chol_forward_kernel<37>", "back_solve_kernel<37>"):
        engine = report.get(kernel, "missing")
        if "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" not in engine:
            raise Failed(f"{kernel} must keep its column in registers: {engine}")
    lib = chol._cuda_lib(torch.device("cuda", 0), 37)
    for name, query, want in (("chol_forward", lib.ase_chol_forward_layout, 32),
                              ("back_solve", lib.ase_back_solve_layout, 8)):
        for n in (37, 48):
            threads, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            chol._raise_on(query(n, ctypes.byref(threads), ctypes.byref(smem),
                                 ctypes.byref(blocks)), "occupancy query")
            warps = blocks.value * threads.value // 32
            print(f"  {name} at n={n}: {threads.value} threads and {smem.value} B of dynamic "
                  f"shared memory per block, {blocks.value} block(s) = {warps} warps per SM")
            if n == 37 and warps < want:
                raise Failed(f"{name} keeps {warps} warps per SM at n=37, want >= {want}")


def _spd(torch, n, m, m2, B, gen):
    A = torch.randn(B, n, n, device="cuda", generator=gen)
    Mb = A @ A.transpose(1, 2) + n * torch.eye(n, device="cuda")
    M = Mb.permute(1, 2, 0).contiguous()
    R = torch.randn(n, m, B, device="cuda", generator=gen)
    R2 = torch.randn(n, m2, B, device="cuda", generator=gen)
    return M, R, R2


def _err(pairs):
    err = 0.0
    for k, p in pairs:
        scale = max(1.0, float(p.abs().max()))
        e = float((k - p).abs().max())
        if not e <= TOL * scale:
            raise Failed(f"kernel disagrees with its plain version: {e} > {TOL} x {scale}")
        err = max(err, e)
    return err


def kernels_phase():
    import torch
    from ase_tpu_torch.ops import chol

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for (n, m, m2, B) in ((37, 72, 1, 4096), (37, 1, 1, 4096), (37, 72, 1, 129), (8, 1, 1, 256)):
        M, R, R2 = _spd(torch, n, m, m2, B, gen)
        L, Y, Y2 = chol.chol_forward(M, R, R2)
        L1, Y1 = chol.chol_forward(M, R)
        x = chol.back_solve(L, Y2)
        torch.cuda.synchronize()
        Lp, Yp, Y2p = chol.chol_forward_plain(M, R, R2)
        xp = chol.back_solve_plain(Lp, Y2p)
        f = 4.0 * B
        tri = n * (n + 1) // 2   # the kernels read only the lower triangle of M or L
        work = {   # (bytes moved, float32 operations)
            "chol_forward2": (f * (tri + n * n + 2 * n * (m + m2)),
                              B * (n ** 3 / 3 + n * n * (m + m2))),
            "chol_forward": (f * (tri + n * n + 2 * n * m), B * (n ** 3 / 3 + n * n * m)),
            "back_solve": (f * (tri + 2 * n * m2), B * n * n * m2),
        }
        errs = {
            "chol_forward2": _err([(L, Lp), (Y, Yp), (Y2, Y2p)]),
            "chol_forward": _err([(L1, Lp), (Y1, Yp)]),
            "back_solve": _err([(x, xp)]),
        }
        times = {
            "chol_forward2": (cuda_ms(torch, lambda: chol.chol_forward(M, R, R2)),
                              cuda_ms(torch, lambda: chol.chol_forward_plain(M, R, R2), 5)),
            "chol_forward": (cuda_ms(torch, lambda: chol.chol_forward(M, R)),
                             cuda_ms(torch, lambda: chol.chol_forward_plain(M, R), 5)),
            "back_solve": (cuda_ms(torch, lambda: chol.back_solve(L, Y2)),
                           cuda_ms(torch, lambda: chol.back_solve_plain(L, Y2), 5)),
        }
        engine = (n, m, m2, B) == (37, 72, 1, 4096)
        cold = {"back_solve": cold_ms(torch, chol.back_solve, (L, Y2), work["back_solve"][0])}
        if engine:
            cold["chol_forward2"] = cold_ms(torch, chol.chol_forward, (M, R, R2),
                                            work["chol_forward2"][0])
            cold["chol_forward"] = cold_ms(torch, chol.chol_forward, (M, R),
                                           work["chol_forward"][0])
        # library yardstick (never called by the port): batch-first
        # torch.linalg.cholesky + solve_triangular on pre-transposed inputs
        Mb = M.permute(2, 0, 1).contiguous()
        Rb = R.permute(2, 0, 1).contiguous()
        RRb = torch.cat([R, R2], dim=1).permute(2, 0, 1).contiguous()
        Lb = torch.linalg.cholesky(Mb)
        yb = Y2.permute(2, 0, 1).contiguous()

        def lib_chol(Ab):    # cholesky_ex: no error check, so no host sync in the graph
            return torch.linalg.cholesky_ex(Ab, check_errors=False).L

        lib = {
            "chol_forward2": cuda_ms(torch, lambda: torch.linalg.solve_triangular(
                lib_chol(Mb), RRb, upper=False)),
            "chol_forward": cuda_ms(torch, lambda: torch.linalg.solve_triangular(
                lib_chol(Mb), Rb, upper=False)),
            "back_solve": cuda_ms(torch, lambda: torch.linalg.solve_triangular(
                Lb.mT, yb, upper=True)),
        }
        for k in errs:
            t_bytes = work[k][0] / HBM_BYTES_PER_S * 1e3
            t_ops = work[k][1] / F32_FLOP_PER_S * 1e3
            row = {"max_abs_err": errs[k], "ms": times[k][0], "cold_ms": cold.get(k),
                   "plain_ms": times[k][1],
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": lib[k]}
            print(f"kernel {k} n={n} m={m} m2={m2} B={B}: " + json.dumps(row), flush=True)
            if engine:
                rows[k] = row
    print("kernels (n=37, m=72, m2=1, B=4096): " + "; ".join(
        f"{k} {r['ms']:.4f} ms, cold {r['cold_ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
        f"{r['bound_ms'] / r['cold_ms']:.2f} of it cold; plain {r['plain_ms']:.3f}, "
        f"library {r['library_ms']:.4f}, max err {r['max_abs_err']:.2g})" for k, r in rows.items()))
    return rows


def player_phase(card):
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.ops import chol

    player, cfg = run.build_player(PLAYER_ARGV)
    env = player.env
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    chol.reset_launches()
    t0 = time.time()
    env.generate_fall_states()
    torch.cuda.synchronize()
    t_fall = time.time() - t0
    print(f"fall-state generation: {t_fall:.1f} s for 150 ticks at {env.num_envs} envs "
          f"({card})", flush=True)
    t0 = time.time()
    state = env.initial_state()
    torch.cuda.synchronize()
    print(f"initial reset: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    stats = player.run(num_steps=STEPS, max_chunks=1, env_state=state)
    torch.cuda.synchronize()
    t_steps = time.time() - t0
    launches = dict(chol.LAUNCHES)
    print(f"player stats: {stats}")
    print(f"launches on the player path: {launches}", flush=True)
    want = FALL_LAUNCHES + 2 * env.control_freq_inv * STEPS
    for k in ("chol_forward2", "back_solve"):
        if launches[k] != want:
            raise Failed(f"{k} launched {launches[k]} times, want {want} "
                         f"(150 fall ticks x 2 substeps + {STEPS} steps x 2 ticks x 2 substeps)")
    es = player.env_state
    for what, t in (("obs", es.obs), ("actions", player.last_actions),
                    ("rewards", player.last_rewards)):
        if not bool(torch.isfinite(t).all()):
            raise Failed(f"non-finite {what}")
    if tuple(es.obs.shape) != (4096, 253) or tuple(player.last_actions.shape) != (4096, 31):
        raise Failed(f"unexpected shapes {tuple(es.obs.shape)}, {tuple(player.last_actions.shape)}")
    sps = env.num_envs * STEPS / t_steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"player: {sps:.1f} env-steps/s over {STEPS} control steps x {env.num_envs} envs "
          f"({t_steps:.2f} s); peak device memory {peak:.2f} GiB, {held:.2f} GiB of it held "
          f"before fall-state generation ({card})", flush=True)
    return launches, player


def profile_phase(player, card, steps=1):
    """Device-busy share and top kernels over ``steps`` control steps. The
    profiler's own host overhead lengthens the wall time, so the busy share
    is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state, roll = player.env_state, player.roll
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            state, roll, _, _ = player._policy_step(state, roll)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print("profile: not measured (the profiler recorded no device time)")
        return
    launches = sum(e.count for e in kernels)
    print(f"profile over {steps} control steps ({card}): wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
          f"{launches / steps:.0f} kernel launches per control step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step  {e.count // steps:5d}x  "
              f"{e.key[:90]}")
    chol_us = {k: sum(e.self_device_time_total for e in kernels if k in e.key)
               for k in ("chol_forward_kernel", "back_solve_kernel")}
    print("  Cholesky kernels: " + ", ".join(
        f"{k} {us / 1e3 / steps:.3f} ms/step" for k, us in chol_us.items())
        + f", {100 * sum(chol_us.values()) / busy_us:.2f}% of device busy time")


def check_tick(model, cfg, state, targets):
    """One engine tick from ``state`` on the card (kernels) and on the CPU
    (plain versions), float32 contact solve on both sides. Raises Failed
    unless positions and rotations agree to TICK_POS_TOL and velocities to
    TICK_VEL_RTOL of their scale (the two devices sum float32 products in
    different orders), or unless the card tick skipped the kernels. Returns
    the max errors."""
    import torch
    from ase_tpu_torch.ops import chol
    from ase_tpu_torch.physics import engine

    cfg = cfg._replace(solver=cfg.solver._replace(matvec_bf16=False))
    out = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        st = type(state)(*(x.to(dev) for x in state))
        before = chol.LAUNCHES["chol_forward2"]
        out[dev] = engine.step_batched(m, cfg, engine.Tables(m, cfg), st, targets.to(dev)).state
        launched = chol.LAUNCHES["chol_forward2"] - before
        if launched != (cfg.substeps if dev == "cuda" else 0):
            raise Failed(f"tick on {dev} launched chol_forward2 {launched} times")
    torch.cuda.synchronize()
    errs = {}
    for name in ("root_pos", "root_quat", "joint_q", "hinge_q", "u"):
        a = getattr(out["cuda"], name).cpu()
        b = getattr(out["cpu"], name)
        errs[name] = float((a - b).abs().max())
        tol = TICK_VEL_RTOL * max(1.0, float(b.abs().max())) if name == "u" else TICK_POS_TOL
        print(f"  tick check {name}: max abs err {errs[name]:.3g} (tol {tol:.3g})")
        if not errs[name] <= tol:
            raise Failed(f"card and CPU disagree on {name}: {errs[name]} > {tol}")
    return errs


def check_phase(player):
    """check_tick on 8 envs of the player's state after its run."""
    env = player.env
    st = type(player.env_state.phys)(*(x[:8] for x in player.env_state.phys))
    act = player.last_actions[:8].clamp(-1, 1)
    check_tick(env.model, env.sim_cfg, st,
               env._pd_action_offset[None] + env._pd_action_scale[None] * act)


def main():
    t_start = time.time()
    signal.signal(signal.SIGALRM, _timeout)
    signal.alarm(TOTAL_BUDGET_S)
    card, name = phase("device", device_phase, t_start)
    import torch

    phase("build", build_phase, t_start)
    rows = phase("kernels", kernels_phase, t_start)
    launches, player = phase("player", lambda: player_phase(card), t_start)
    phase("profile", lambda: profile_phase(player, card), t_start)
    phase("check", lambda: check_phase(player), t_start)
    signal.alarm(0)
    replaces = {"chol_forward2": "ase_tpu/ops/pallas_chol.py:122",
                "back_solve": "ase_tpu/ops/pallas_chol.py:145",
                "chol_forward": "ase_tpu/ops/pallas_chol.py:105"}
    # chol_forward (one right-hand side) is public API the engine does not call
    kernels = [dict(name=k, route="cuda", source="ase_tpu_torch/csrc/chol.cu",
                    replaces=replaces[k], launches=launches[k], on_path=k != "chol_forward",
                    **rows[k])
               for k in ("chol_forward2", "back_solve", "chol_forward")]
    print(f"total: {time.time() - t_start:.1f} s (limit {TOTAL_BUDGET_S} s)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Failed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)

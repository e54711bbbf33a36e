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
              PyTorch version on the card at five sizes (the engine's
              n=37, m=72, m2=1, B=4096; the AMP humanoid's n=34 at the same
              m, m2 and B, the kernels' generic instance; the
              factor-dominated m=1 at B=4096; a ragged B=129; n=8; the
              one-env engine.step's B=1 at n=37, m=72; the pendulum's n=1,
              m=9, B=1), with its
              device time, its bound, the plain version's device time and a
              library yardstick's (CUDA events around a CUDA graph of 20
              calls, so host work in a wrapper cannot enter a time). These
              calls reuse one input set, which stays in the 50 MB L2 when
              it is small (``ms``, warm); ``cold_ms`` times the kernels at
              the engine's shape, and back_solve at every size, on calls
              that rotate over copies of the inputs holding more than
              COLD_BYTES, so each call finds L2 cold, as in the engine,
              where other work runs between the calls (at n=37 and n=34;
              B=1 is timed warm only: a cold rotation would need ~33,000
              copies of its inputs).
4. cache   -- the native motion cache: the file ``_cache_path`` names for
              the dataset yaml with the engine's dof ids is deleted, the
              extension built (g++, timed), and the library loaded twice on
              the card: a miss that parses the 87 clips and writes the file,
              then a hit that maps it. Both wall times are printed; the
              second load must count a hit and every tensor of the two
              libraries must be bit-equal. Every later phase that loads the
              dataset loads it from this file.
4b. player -- ``ase_tpu_torch.run``'s player on HumanoidAMPGetup with the
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
6b. oracle -- the AoS oracles against the batched forms the engine runs,
              both on the card, at ORACLE_ENVS random poses
              (tests/test_dynamics2.py's states): ``dynamics.fk`` against
              ``dynamics2.fk_batched``, ``compute_dynamics`` against
              ``compute_dynamics_batch_last`` (M and bias to 2e-5 of scale,
              Phi to 1e-5), ``pd_torques`` and ``limit_torques`` against the
              joint-batched forms, ``collision2.detect`` against
              ``collision3.detect_batched`` at K = 24 (sorted depths to 2e-5;
              normal, position and friction to 1e-4 at matching depth ranks,
              but for ORACLE_ATTR_SHARE of them, held to 1e-3: the normals
              of deep, near-concentric self-penetrations round to ~1e-4
              over so many poses). Then the
              one-env ``engine.step`` (B = 1) for ORACLE_TICKS ticks from a
              perturbed standing pose, each tick card against CPU at
              ``check_tick``'s tolerances, exactly 2 x ORACLE_TICKS launches
              of chol_forward2 and back_solve; and the reference's pendulum
              (one hinge on a fixed base: n = 1) for PENDULUM_TICKS ticks on
              the card, its period within 5% of the analytic one and its
              late amplitude within 10% of its early one.
7. hrl     -- ``ase_tpu_torch.run``'s player on HumanoidHeading: the shipped
              heading high-level controller (1024-512) over the shipped
              low-level controller at 4096 envs, for one chunk of
              HRL_DECISIONS decisions of 5 control steps each. The kernel
              launch counters are zeroed just before and read just after:
              exactly HRL_DECISIONS x 20 of each (no reset steps the engine: the
              heading task starts from the default pose). Env-steps/s, the
              mean task reward, the mean windowed LLC discriminator reward
              and the player's probe are printed. Then ``check_hrl``: one
              decision's window on 64 of those envs, on the card and on the
              CPU, from the same state and goal draws.
8. train   -- ``ase_tpu_torch.run``'s training branch with the shipped
              ase_humanoid.yaml at its full widths and 4096 envs for
              TRAIN_EPOCHS epoch (only the epoch count is cut; the player
              phase's fall states reused): per epoch the wall time with its
              rollout/update split, training
              env-steps/s, the losses, the Cholesky kernels' launches
              (exactly 128 each: 32 steps x 2 ticks x 2 substeps; counters
              zeroed after construction) and peak device memory. Every
              metric must be finite, the weights must change and the
              latents stay unit-norm. Then ``check_minibatch``: one
              full-width minibatch update of 256 rows from the same weights,
              batch and draws on the card and on the CPU, held against a
              float64 witness: losses, every gradient before the Adam step,
              the step itself and the new weights (shared with
              tests/test_torch_cuda.py). Then save and resume: the run's
              final checkpoint (``Humanoid.ckpt.npz`` in a temporary
              directory under chiprun_out/) goes into a new agent built by
              ``run.build_agent`` with ``--resume 1 --checkpoint <it>
              --max_iterations TRAIN_EPOCHS + 1``; its weights, Adam moments
              and steps, three normalizers and epoch must be bit-equal to
              the saved agent's; it trains one more epoch (TRAIN_LAUNCHES
              launches each), and the directory is deleted.
9. train_bf16 -- the same training branch under ``mixed_precision: true``
              (bfloat16 dense layers over float32 parameters and heads) for
              TRAIN_BF16_EPOCHS epoch of CUT_HORIZON steps, the train phase's
              fall states reused: exactly CUT_LAUNCHES of each kernel, finite
              metrics, every
              weight changed, the actor's activations bfloat16 on the card
              and the parameters float32. Then ``check_minibatch_bf16``:
              one full-width 256-row update on the card and on the CPU, both
              bf16, the card on the CPU's relu gates, at the bounds its
              docstring derives from bf16 rounding.
9b. evalskills -- ``tools.eval_llc_skills.main`` with the shipped LLC
              (EVALSKILLS_ARGV: 256 latents x 16 steps on HumanoidAMP, 256
              getup envs x 32 steps from the train phase's fall states, so
              no 150-tick drop): finite stats, 256 latents, some fall
              states, exactly EVALSKILLS_LAUNCHES of chol_forward2 and
              back_solve; the stats printed as JSON.
10. strike -- ``ase_tpu_torch.run``'s player on HumanoidStrike: the shipped
              strike high-level controller over the shipped low-level
              controller at 4096 envs (one free prop each, the target box),
              one chunk of STRIKE_DECISIONS decisions, as the hrl phase;
              exactly STRIKE_DECISIONS x 20 of each kernel (default-pose starts: no reset
              steps the engine). Env-steps/s, decisions/s, the mean task
              reward, the windowed LLC discriminator reward and the success
              rates are printed.
11. strike_profile -- one strike control step (a decision cut to one LLC
              step) under torch.profiler: launches per control step and
              device-busy share with a prop.
12. strike_check -- ``check_tick`` on 8 of those envs (the box stands on
              the plane, so prop contacts are always present).
13. hrl_train -- ``ase_tpu_torch.run``'s training branch on HumanoidStrike
              with the shipped hrl_humanoid.yaml at its widths (1024-512)
              over the shipped LLC, 4096 envs, HRL_TRAIN_EPOCHS epoch of
              HRL_TRAIN_HORIZON decisions (only the epoch count and the
              horizon are cut): exactly HRL_TRAIN_LAUNCHES of each
              kernel, finite losses, every HLC weight changed, the LLC
              bit-equal to its checkpoint, peak device memory; then the
              final checkpoint resumed into a new agent (``run.build_agent
              --resume 1``): HLC weights, Adam state, normalizers and epoch
              bit-equal, and no further epoch.
14. perturb -- ``ase_tpu_torch.run``'s ASE player with the shipped LLC on
              HumanoidPerturb (13 box projectiles per env) at 4096 envs for
              PERTURB_STEPS control steps (the first projectiles launch at
              steps 60 and 67): exactly PERTURB_LAUNCHES of each kernel, and
              the share of envs still above their termination heights.
15. perturb_check -- ``check_tick`` on 8 envs with a projectile in flight
              near the character or in contact.
16. dr     -- one ASE training epoch under domain randomization: HumanoidAMP
              on humanoid_ase_sword_shield.yaml with ase_humanoid.yaml and
              ``--randomize``, the block of ``dr_block()`` (frequency 2,
              every knob and both noises on), 4096 envs, through the
              constructors ``run.build_agent`` uses, an epoch of CUT_HORIZON
              steps: exactly CUT_LAUNCHES of each kernel, finite metrics,
              every knob away from its base
              in some env, every env reset at least once; then one control
              step (reset pass, actor, two ticks) profiled with the
              randomizer on and off: the launches the knobs add.
17. dr_check -- ``check_tick`` on DR_CHECK_ENVS of those envs with every
              knob away from its base (restitution and actor scale
              included), card against CPU.
18. pgs    -- the ASE player with the shipped LLC on HumanoidAMP
              (humanoid_ase_sword_shield.yaml) at PGS_ENVS envs, built twice
              by ``run.build_player``: with ``solverScheme: pgs`` (the
              sequential Gauss-Seidel contact solve over library Cholesky
              factors and triangular solves), then as shipped (block-Jacobi),
              each for PGS_STEPS control steps: exactly 0 launches of every
              kernel on the PGS run and PGS_JACOBI_LAUNCHES of chol_forward2
              and back_solve on the Jacobi run; finite obs, actions and
              rewards, except in the envs whose PGS solve diverged, as the
              reference's does (at most PGS_DIVERGED_SHARE of them); both
              env-steps/s and their ratio, and each run's launches per
              control step and device-busy share (one profiled step).
19. pgs_check -- ``check_tick`` under the PGS scheme on PGS_CHECK_ENVS of
              the PGS run's envs whose solve did not diverge, card against
              CPU.
20. viewmotion -- ``run.build_player`` with ``--test --task
              HumanoidViewMotion`` (kinematic playback of the dataset under
              torque control, one tick a control step) at VIEW_ENVS envs for
              VIEW_STEPS control steps: exactly VIEW_LAUNCHES of chol_forward2
              and back_solve; body positions finite and at or above -0.1 m;
              env-steps/s. Then ``check_viewmotion``: one control step on
              VIEW_CHECK_ENVS envs, card against CPU, body positions within
              TICK_POS_TOL, and VIEW_QUERIES random motion-library queries'
              frames, card against CPU, within the same.
21. savevideo -- ``run.main`` with the hrl phase's argv and
              ``--save_video`` (a temporary directory) at 4096 envs for
              HRL_DECISIONS decisions: the player keeps env 0's body
              positions and heading markers on the card, one frame a
              decision, copied to the host once per chunk; exactly
              HRL_DECISIONS frames reach the renderer, with finite markers,
              the last bit-equal to the player's final state; exactly
              SAVEVIDEO_LAUNCHES of chol_forward2 and back_solve; the
              env-steps/s beside the hrl phase's and their ratio. Where
              matplotlib imports the video file must be written (its render
              time printed); where it does not, that is printed and nothing
              is rendered.
22. mocap  -- in a temporary directory: ``tools.fbx_importer`` on the
              vendored CMU FBX at 60 fps, bit-equal to the vendored import;
              ``tools.retarget_motion`` onto the AMP humanoid; the clip's
              ``skeleton.fk`` on the card within FK_POS_TOL of ``np_fk`` and
              ``global_to_local`` of it within FK_ROT_TOL of the input
              rotations (up to sign); HumanoidAMP on humanoid.yaml (15
              bodies, nu = 34) on that clip at MOCAP_ENVS envs behind
              ``VecEnv``: ``reset()`` and MOCAP_STEPS random steps, exactly
              MOCAP_LAUNCHES of chol_forward2 and back_solve, finite
              observations and AMP observations and a demo fetch; then
              ``check_vec_step``: one step on MOCAP_CHECK_ENVS envs, card
              against CPU, within ``check_tick``'s tolerances.
23. multi  -- data-parallel training: MULTI_RANKS ranks on the one card, a
              gloo group staging its collectives through host memory (NCCL
              refuses two ranks on one device), spawned as processes that
              each run ``run.build_agent(MULTI_ARGV, mesh=...)`` and
              ``agent.train``: one epoch of ase_humanoid.yaml at its full
              widths on HumanoidAMP (the dr phase's env without the
              randomizer) at MULTI_ENVS envs in all. Each rank must launch
              exactly CUT_LAUNCHES (horizon CUT_HORIZON) of chol_forward2 and back_solve and no
              chol_forward, every metric must be finite and the ranks'
              weight checksums bit-equal; a rank that exits non-zero or
              outlives the phase budget fails it (and is killed). The global
              env-steps/s is printed beside the one-rank train and dr rates.
24. nccl   -- a world-1 NCCL group in this process through
              ``parallel.mesh.init()``: all_reduce_sum, all_gather_rows and
              broadcast on CUDA tensors with known answers, then the group
              is destroyed.

Any failure exits non-zero. The last two lines are the kernels JSON and the
result JSON ``{"ok": true, "device": {...}}``.
"""

import itertools
import json
import math
import multiprocessing
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

STEPS = 16
FALL_LAUNCHES = 150 * 2          # fall-state drop: 150 ticks x 2 substeps
TOTAL_BUDGET_S = 570
TRAIN_EPOCHS = 1
TRAIN_LAUNCHES = 32 * 2 * 2      # per epoch: horizon 32 x 2 ticks x 2 substeps
CUT_HORIZON = 16                 # the train_bf16, dr and multi epochs' horizon (the shipped
                                 # 32 before the oracle and evalskills phases came)
CUT_LAUNCHES = CUT_HORIZON * 2 * 2
HRL_DECISIONS = 8                # 16 before the oracle and evalskills phases came
STRIKE_DECISIONS = 8             # 16 before the oracle and evalskills phases came
HRL_TRAIN_EPOCHS = 1
HRL_TRAIN_HORIZON = 16           # decisions an epoch (the shipped 32 before the oracle and
                                 # evalskills phases came)
HRL_TRAIN_LAUNCHES = HRL_TRAIN_HORIZON * 5 * 2 * 2 # per epoch: decisions of 5 control steps
PERTURB_STEPS = 68               # 72 before the oracle and evalskills phases came
PERTURB_LAUNCHES = PERTURB_STEPS * 2 * 2
PGS_ENVS = 4096
PGS_STEPS = 4                    # 8 before the oracle and evalskills phases came
PGS_JACOBI_LAUNCHES = PGS_STEPS * 2 * 2          # the Jacobi twin: 2 ticks x 2 substeps
PGS_CHECK_ENVS = 8
PGS_DIVERGED = 1e10              # an impulse (N s) no converging PGS solve reaches (the phase
                                 # prints the largest the others reached); a diverging sweep
                                 # passes it within one substep (tests/test_torch_pgs.py)
PGS_DIVERGED_SHARE = 0.01        # ... the share of envs allowed to diverge in a run
VIEW_ENVS = 4096
VIEW_STEPS = 8                   # 16 before the oracle and evalskills phases came
VIEW_LAUNCHES = VIEW_STEPS * 1 * 2               # view motion: 1 tick x 2 substeps a step
VIEW_CHECK_ENVS = 64
VIEW_QUERIES = 65536
SAVEVIDEO_LAUNCHES = HRL_DECISIONS * 5 * 2 * 2     # the hrl phase's run, one frame a decision
MOCAP_FBX = "data/poselib/09_11_cmu.fbx"
MOCAP_IMPORTED = "data/poselib/09_11_cmu_imported.npy"   # the vendored 60 fps import
RETARGET_CFG = "data/retarget_cfg/retarget_cmu_to_amp.json"
MOCAP_ENVS = 4096
MOCAP_STEPS = 8                  # 16 before the oracle and evalskills phases came
MOCAP_LAUNCHES = MOCAP_STEPS * 2 * 2             # 2 ticks x 2 substeps a control step
MOCAP_CHECK_ENVS = 8
FK_POS_TOL = 1e-5                # fk on the card vs np_fk: positions (m)
FK_ROT_TOL = 1e-6                # ... rotations, and global_to_local(fk) vs the input, up to sign
MOCAP_ARGV = [
    "--task", "HumanoidAMP",
    "--cfg_env", "humanoid.yaml",
    "--cfg_train", "train/rlg/amp_humanoid.yaml",
    "--num_envs", str(MOCAP_ENVS), "--seed", "0",
]
BUDGET_S = {"device": 60, "build": 120, "kernels": 120, "player": 360, "profile": 60,
            "check": 60, "hrl": 240, "hrl_check": 120, "train": 300, "train_bf16": 150,
            "strike": 240, "strike_profile": 60, "strike_check": 60, "hrl_train": 300,
            "perturb": 240, "perturb_check": 60, "dr": 120, "dr_check": 60, "cache": 60,
            "pgs": 120, "pgs_check": 60, "viewmotion": 90, "multi": 150, "nccl": 30,
            "savevideo": 90, "mocap": 90, "oracle": 75, "evalskills": 60}
REPO = os.path.dirname(os.path.abspath(__file__))
DATASET = "data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml"
HRL_ARGV = [
    "--test", "--task", "HumanoidHeading",
    "--cfg_env", "humanoid_sword_shield_heading.yaml",
    "--cfg_train", "train/rlg/hrl_humanoid.yaml",
    "--motion_file", DATASET,
    "--llc_checkpoint", "data/models/ase_llc_reallusion_sword_shield.ckpt.npz",
    "--checkpoint", "data/models/ase_hlc_heading_reallusion_sword_shield.ckpt.npz",
    "--seed", "0",
]
LLC = "data/models/ase_llc_reallusion_sword_shield.ckpt.npz"
STRIKE_HLC = "data/models/ase_hlc_strike_reallusion_sword_shield.ckpt.npz"
STRIKE_ARGV = [
    "--task", "HumanoidStrike",
    "--cfg_env", "humanoid_sword_shield_strike.yaml",
    "--cfg_train", "train/rlg/hrl_humanoid.yaml",
    "--motion_file", DATASET,
    "--llc_checkpoint", LLC,
    "--num_envs", "4096", "--seed", "0",
]
PERTURB_ARGV = [
    "--test", "--task", "HumanoidPerturb",
    "--cfg_env", "humanoid_ase_sword_shield.yaml",
    "--cfg_train", "train/rlg/ase_humanoid.yaml",
    "--motion_file", DATASET,
    "--checkpoint", LLC,
    "--num_envs", "4096", "--seed", "0",
]
PGS_ARGV = [
    "--test", "--task", "HumanoidAMP",
    "--cfg_env", "humanoid_ase_sword_shield.yaml",
    "--cfg_train", "train/rlg/ase_humanoid.yaml",
    "--motion_file", DATASET,
    "--checkpoint", LLC,
    "--seed", "0",
]
VIEW_ARGV = ["--test", "--task", "HumanoidViewMotion"] + PGS_ARGV[3:]
HRL_CHECK_ENVS = 64
HRL_MU_RTOL = 1e-4               # window card vs CPU: the HLC's mu and the first LLC actions,
HRL_OBS_RTOL = 1e-3              # ... the first step's observations and rewards, of their scale
PLAYER_ARGV = [
    "--test", "--task", "HumanoidAMPGetup",
    "--cfg_env", "humanoid_ase_sword_shield_getup.yaml",
    "--cfg_train", "train/rlg/ase_humanoid.yaml",
    "--motion_file", "data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml",
    "--checkpoint", "data/models/ase_llc_reallusion_sword_shield.ckpt.npz",
    "--num_envs", "4096",
]
TRAIN_ARGV = [
    "--task", "HumanoidAMPGetup",
    "--cfg_env", "humanoid_ase_sword_shield_getup.yaml",
    "--cfg_train", "train/rlg/ase_humanoid.yaml",
    "--motion_file", "data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml",
    "--num_envs", "4096", "--max_iterations", str(TRAIN_EPOCHS), "--seed", "0",
]
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # float32 outside the tensor cores
COLD_BYTES = 100e6               # twice the H100's 50 MB L2
TOL = 1e-4                       # relative to the largest plain-version magnitude
TICK_POS_TOL = 5e-5              # one tick, card vs CPU: positions and rotations, absolute
TICK_VEL_RTOL = 1e-4             # ... velocities, relative to their largest magnitude
MB_LOSS_RTOL = 1e-4              # minibatch update, card vs CPU: losses, of max(1, |loss|)
MB_GRAD_RTOL = 1e-4              # ... gradients vs a float64 witness, of each tensor's largest
MB_GATE_RTOL = 1e-5              # ... a relu gate off the witness's: |pre-activation| of the layer's largest
MB_STEP_ATOL = 1e-3              # ... new weights vs Adam's first step from the side's own gradients, x lr
MB_W_ATOL = 1e-2                 # ... new weights card vs CPU, x lr, where the witness's |g| is
MB_W_GMIN = 1e-4                 #     above MB_W_GMIN of its tensor's largest
MB16_FWD_RTOL = 2.0 ** -6        # bf16 minibatch, card vs CPU: policy means, of their largest
MB16_LOSS_RTOL = 2.0 ** -8       # ... losses, of max(1, |loss|)
MB16_GRAD_RTOL = 2.0 ** -5       # ... gradients, of each tensor's largest (4 bf16 ulps)
MB16_ROW_RTOL = 2.0 ** -6        # ... a bias gradient, also of its layer's sum of |cotangent|
MB16_GATE_RTOL = 2.0 ** -5       # ... a relu gate off the CPU's: |pre-activation| of the layer's largest
TRAIN_BF16_EPOCHS = 1
DR_EPOCHS = 1
DR_CHECK_ENVS = 8
DR_ENVS = 4096
DR_ARGV = [
    "--task", "HumanoidAMP",
    "--cfg_env", "humanoid_ase_sword_shield.yaml",
    "--cfg_train", "train/rlg/ase_humanoid.yaml",
    "--motion_file", DATASET,
    "--num_envs", str(DR_ENVS), "--max_iterations", str(DR_EPOCHS), "--seed", "0",
    "--randomize", "--horizon_length", str(CUT_HORIZON),
]


MULTI_RANKS = 2
MULTI_ENVS = 4096
MULTI_ARGV = [
    "--task", "HumanoidAMP",
    "--cfg_env", "humanoid_ase_sword_shield.yaml",
    "--cfg_train", "train/rlg/ase_humanoid.yaml",
    "--motion_file", DATASET,
    "--num_envs", str(MULTI_ENVS), "--max_iterations", "1", "--seed", "0", "--multi_gpu",
    "--horizon_length", str(CUT_HORIZON),
]


def dr_block():
    """The randomization_params block that tests/test_domain_rand.py
    holds the reference to: frequency 2, every knob and both noises on."""
    def spec(lo, hi, op, dist):
        return {"range": [lo, hi], "operation": op, "distribution": dist}

    return {
        "frequency": 2,
        "observations": spec(0.0, 0.002, "additive", "gaussian"),
        "actions": spec(0.0, 0.02, "additive", "gaussian"),
        "sim_params": {"gravity": spec(0.8, 1.2, "scaling", "uniform")},
        "actor_params": {"humanoid": {
            "scale": spec(0.85, 1.15, "scaling", "uniform"),
            "rigid_body_properties": {"mass": spec(0.7, 1.3, "scaling", "uniform")},
            "rigid_shape_properties": {"friction": spec(0.7, 1.3, "scaling", "uniform"),
                                       "restitution": spec(0.0, 0.7, "additive", "uniform")},
            "dof_properties": {"stiffness": spec(0.8, 1.2, "scaling", "uniform"),
                               "damping": spec(0.5, 1.5, "scaling", "uniform")},
        }},
    }


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
    rows, rows34, rows1 = {}, {}, {}
    for (n, m, m2, B) in ((37, 72, 1, 4096), (34, 72, 1, 4096), (37, 1, 1, 4096),
                          (37, 72, 1, 129), (8, 1, 1, 256), (37, 72, 1, 1), (1, 9, 1, 1)):
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
        engine = (m, m2, B) == (72, 1, 4096) and n in (37, 34)
        # at B = 1 a cold rotation would take ~33,000 copies of the inputs
        cold = {} if B == 1 else {
            "back_solve": cold_ms(torch, chol.back_solve, (L, Y2), work["back_solve"][0])}
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
                (rows if n == 37 else rows34)[k] = row
            elif (n, B) == (37, 1):
                rows1[k] = row
    for n, rs in ((37, rows), (34, rows34)):
        print(f"kernels (n={n}, m=72, m2=1, B=4096): " + "; ".join(
            f"{k} {r['ms']:.4f} ms, cold {r['cold_ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
            f"{r['bound_ms'] / r['cold_ms']:.2f} of it cold; plain {r['plain_ms']:.3f}, "
            f"library {r['library_ms']:.4f}, max err {r['max_abs_err']:.2g})"
            for k, r in rs.items()))
    print("kernels at B = 1 (n=37, m=72, m2=1; the one-env engine.step): " + "; ".join(
        f"{k} {r['ms']:.4f} ms (bound {r['bound_ms']:.6f}; plain {r['plain_ms']:.3f}, library "
        f"{r['library_ms']:.4f}, max err {r['max_abs_err']:.2g})" for k, r in rows1.items()))
    for k, r in rows.items():
        r["amp_humanoid"] = {f: rows34[k][f] for f in ("ms", "cold_ms", "plain_ms", "library_ms",
                                                       "max_abs_err", "bound_ms")}
        r["one_env"] = {f: rows1[k][f] for f in ("ms", "plain_ms", "library_ms", "max_abs_err",
                                                 "bound_ms", "bound_by")}
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
    if launches["chol_forward"] != 0:
        raise Failed(f"chol_forward launched {launches['chol_forward']} times on the player "
                     "path, which calls only chol_forward2")
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
    """Device-busy share and top kernels over ``steps`` control steps of
    the player."""
    carry = [player.env_state, player.roll]

    def step():
        carry[0], carry[1], _, _ = player._policy_step(*carry)

    return _profile(type(player.env).__name__, step, card, steps)


def _profile(label, step, card, steps=1):
    """Device-busy share and top kernels over ``steps`` calls of
    ``step()``, one control step each; returns the kernel launches per
    control step (None if the profiler records no device time). The
    profiler's own host overhead lengthens the wall time, so the busy share
    is a lower bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print("profile: not measured (the profiler recorded no device time)")
        return None
    launches = sum(e.count for e in kernels)
    print(f"profile of {label} over {steps} control steps ({card}): wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / wall_us:.1f}%), {launches / steps:.0f} kernel launches per control step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step  {e.count // steps:5d}x  "
              f"{e.key[:90]}")
    chol_us = {k: sum(e.self_device_time_total for e in kernels if k in e.key)
               for k in ("chol_forward_kernel", "back_solve_kernel")}
    print("  Cholesky kernels: " + ", ".join(
        f"{k} {us / 1e3 / steps:.3f} ms/step" for k, us in chol_us.items())
        + f", {100 * sum(chol_us.values()) / busy_us:.2f}% of device busy time")
    return launches / steps


def check_tick(model, cfg, state, targets, knobs=None):
    """One engine tick from ``state`` on the card (kernels) and on the CPU
    (plain versions), float32 contact solve on both sides, with the domain
    randomization ``knobs`` of ``engine.step_batched`` if given. Raises
    Failed unless positions and rotations (of the props too) agree to
    TICK_POS_TOL and velocities to
    TICK_VEL_RTOL of their scale (the two devices sum float32 products in
    different orders), or unless the card tick skipped the kernels (the
    Jacobi scheme's chol_forward2 once a substep; the PGS scheme launches
    none). Returns the max errors."""
    import torch
    from ase_tpu_torch.ops import chol
    from ase_tpu_torch.physics import engine

    cfg = cfg._replace(solver=cfg.solver._replace(matvec_bf16=False))
    out = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        st = type(state)(*(x.to(dev) for x in state))
        before = chol.LAUNCHES["chol_forward2"]
        kw = {k: v.to(dev) for k, v in (knobs or {}).items()}
        out[dev] = engine.step_batched(m, cfg, engine.Tables(m, cfg), st, targets.to(dev),
                                       **kw).state
        launched = chol.LAUNCHES["chol_forward2"] - before
        jacobi = cfg.solver.scheme == "jacobi"
        if launched != (cfg.substeps if dev == "cuda" and jacobi else 0):
            raise Failed(f"tick on {dev} launched chol_forward2 {launched} times")
    torch.cuda.synchronize()
    errs = {}
    for name in ("root_pos", "root_quat", "joint_q", "hinge_q", "prop_pos", "prop_quat", "u"):
        a = getattr(out["cuda"], name).cpu()
        b = getattr(out["cpu"], name)
        if not b.numel():      # no props
            continue
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


def hrl_phase(card, argv, obs_dim, decisions, name):
    """An HRL player (the heading or the strike controller over the shipped
    LLC) at 4096 envs for ``decisions`` decisions; returns the launch
    counts of the run, the player and its env-steps/s."""
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.ops import chol

    t0 = time.time()
    player, _ = run.build_player(argv)
    agent, env = player.agent, player.env
    player.debug_probes = True
    widths = {"hlc": [l.out_features for l in agent.network.actor_mlp.layers],
              "llc": [l.out_features for l in agent._llc_network.actor_mlp.layers],
              "obs": agent.obs_dim, "latent": agent.action_dim, "llc_steps": agent._llc_steps,
              "envs": env.num_envs}
    want = {"hlc": [1024, 512], "llc": [1024, 1024, 512], "obs": obs_dim, "latent": 64,
            "llc_steps": 5, "envs": 4096}
    if widths != want:
        raise Failed(f"{name} phase not at the shipped widths: {widths}")
    state = env.initial_state()
    torch.cuda.synchronize()
    print(f"{name} setup: {time.time() - t0:.1f} s (LLC and HLC restore, motion library, "
          f"initial reset); widths {widths}, {env.model.num_props} props", flush=True)

    window = []
    env_step = agent._env_step

    def record(env_state, actions):
        out = env_step(env_state, actions)
        succ = out[0].aux.get("successes", torch.zeros_like(out[1]))
        window.append(torch.stack([out[1].mean(), out[2]["disc_rewards"].mean(), succ.mean()]))
        return out

    agent._env_step = record
    chol.reset_launches()
    t0 = time.time()
    stats = player.run(num_steps=decisions, max_chunks=1, env_state=state)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(chol.LAUNCHES)
    agent._env_step = env_step
    print(f"{name} player stats: {stats}")
    print(f"launches on the {name} path: {launches}", flush=True)
    n = decisions * 5 * 2 * 2
    if launches != {"chol_forward2": n, "back_solve": n, "chol_forward": 0}:
        raise Failed(f"{name} launches {launches}, want {n} of chol_forward2 and back_solve "
                     f"({decisions} decisions x 5 LLC steps x 2 ticks x 2 substeps; no reset "
                     "steps the engine) and no chol_forward")
    es = player.env_state
    for what, t in (("obs", es.obs), ("actions", player.last_actions),
                    ("rewards", player.last_rewards), ("props", es.phys.prop_pos)):
        if not bool(torch.isfinite(t).all()):
            raise Failed(f"{name}: non-finite {what}")
    if tuple(es.obs.shape) != (4096, obs_dim) or tuple(player.last_actions.shape) != (4096, 64):
        raise Failed(f"{name}: unexpected shapes {tuple(es.obs.shape)}, "
                     f"{tuple(player.last_actions.shape)}")
    task_r, disc_r, succ = torch.stack(window).mean(0).tolist()
    steps = decisions * agent._llc_steps
    rate = env.num_envs * steps / dt
    print(f"{name}: {rate:.1f} env-steps/s ({decisions / dt:.2f} decisions/s) "
          f"over {decisions} decisions x {agent._llc_steps} control steps x {env.num_envs} envs "
          f"({dt:.2f} s); mean task reward {task_r:.4f}, mean windowed LLC disc reward "
          f"{disc_r:.4f}, llc_disc_reward probe (env 0) {stats['llc_disc_reward']:.4f}"
          + (f"; successes at a window's end {succ:.4f} (mean over decisions), success rate "
             f"of finished games {stats['success_rate']:.4f} over {stats['episodes']} games"
             if "successes" in es.aux else "") + f" ({card})", flush=True)
    return launches, player, rate


def _env_state_to(state, idx, device):
    """Rows ``idx`` of an env state, on ``device``."""
    from ase_tpu_torch.envs.humanoid import take

    sub = take(state, idx)
    return sub.replace(phys=type(sub.phys)(*(x.to(device) for x in sub.phys)),
                       aux={k: v.to(device) for k, v in sub.aux.items()},
                       **{k: v.to(device) for k, v in vars(sub).items() if k not in ("phys", "aux")})


def check_hrl(player, device="cuda"):
    """One decision's window (the HLC's mu, then 5 LLC steps) on
    HRL_CHECK_ENVS of the HRL player's envs, copied from the card, on the
    card and on the CPU with the same goal draws and a float32 contact
    solve on both sides (as ``check_tick``; with the default bf16 Delassus
    product the first step's observations differed by 9.6e-4 of scale,
    card vs CPU, on an H100): the HLC's mu
    and the first LLC step's actions agree to HRL_MU_RTOL of their scale,
    that step's observations and rewards to HRL_OBS_RTOL; the later steps
    of the window must be finite (contact dynamics amplify rounding from
    step to step). Returns the errors."""
    import torch
    from ase_tpu_torch import run

    n = HRL_CHECK_ENVS
    idx = torch.arange(n, device=player.env.device)
    goals, out = None, {}
    for dev in dict.fromkeys((device, "cpu")):
        p, _ = run.build_player(HRL_ARGV + ["--num_envs", str(n), "--device", dev])
        agent, env = p.agent, p.env
        env.sim_cfg = env.sim_cfg._replace(solver=env.sim_cfg.solver._replace(matvec_bf16=False))
        if goals is None:
            goals = _goal_draws(env, torch.Generator().manual_seed(0), n)
        draws = iter([{k: v.to(dev) for k, v in d.items()} for d in goals])
        env._draw_goal = lambda m: next(draws)
        state = _env_state_to(player.env_state, idx, dev)
        steps = []
        env_step = env.step

        def record(s, a):
            o = env_step(s, a)
            steps.append((a, o))
            return o

        env.step = record
        with torch.no_grad():
            mu, _ = agent._actor_sigma(agent.obs_rms.normalize(state.obs), {})
            _, rew, infos = agent._env_step(state, mu)
        out[dev] = {"mu": mu, "actions": steps[0][0], "obs": steps[0][1].obs,
                    "rew": steps[0][1].rew,
                    "later": [torch.cat([o.obs, o.rew[:, None]], 1) for _, o in steps[1:]]
                    + [rew[:, None], infos["disc_rewards"]]}
    errs = {}
    for k, rtol in (("mu", HRL_MU_RTOL), ("actions", HRL_MU_RTOL), ("obs", HRL_OBS_RTOL),
                    ("rew", HRL_OBS_RTOL)):
        a, b = out[device][k].cpu(), out["cpu"][k]
        scale = max(1.0, float(b.abs().max()))
        errs[k] = float((a - b).abs().max()) / scale
        print(f"  hrl window check {k}: {errs[k]:.3g} of scale (tol {rtol})")
        if not errs[k] <= rtol:
            raise Failed(f"hrl window: card and CPU disagree on {k}: {errs[k]:.3g} of scale")
    for dev, o in out.items():
        if not all(bool(torch.isfinite(t).all()) for t in o["later"]):
            raise Failed(f"hrl window on {dev}: non-finite observations or rewards after step 1")
    return errs


def _goal_draws(env, gen, n):
    """One heading-goal draw per LLC step of a window, from ``gen`` (CPU)."""
    import math

    import torch

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen)

    return [{"goal_theta": u(-math.pi, math.pi), "goal_face_theta": u(-math.pi, math.pi),
             "goal_speed": u(env._tar_speed_min, env._tar_speed_max),
             "goal_change_steps": torch.randint(env._heading_change_steps_min,
                                                env._heading_change_steps_max, (n,),
                                                generator=gen)}
            for _ in range(5)]


def _train_widths(agent, horizon=32):
    """The shipped config's full widths, as the train phase must run them
    (the train_bf16 phase at a cut ``horizon``)."""
    net = agent.network
    got = {
        "actor": [l.out_features for l in net.actor_mlp.layers],
        "critic": [l.out_features for l in net.critic_mlp.layers],
        "disc": [l.out_features for l in net.disc_mlp.layers],
        "style": [l.out_features for l in net.style_net.mlp.layers],
        "latent_dim": agent._latent_dim, "minibatch": agent.minibatch_size,
        "mini_epochs": agent.mini_epochs, "minibatches": agent.num_minibatches,
        "demo_buffer": agent.demo_buffer.capacity, "replay_buffer": agent.replay_buffer.capacity,
        "envs": agent.num_actors, "horizon": agent.horizon_length,
    }
    want = {"actor": [1024, 1024, 512], "critic": [1024, 1024, 512], "disc": [1024, 1024, 512],
            "style": [512, 256], "latent_dim": 64, "minibatch": 16384, "mini_epochs": 6,
            "minibatches": horizon // 4, "demo_buffer": 200000, "replay_buffer": 200000,
            "envs": 4096, "horizon": horizon}
    if got != want:
        raise Failed(f"train phase not at the shipped widths: {got}")
    return got


def _in_temp_dir(prefix, fn):
    """``fn(out_dir)`` with a fresh directory under chiprun_out/, deleted
    afterwards."""
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix=prefix, dir=os.path.join(REPO, "chiprun_out"))
    try:
        return fn(out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def train_phase(card, rows, fall_states):
    """TRAIN_EPOCHS epochs of ``ase_tpu_torch.run``'s training branch (its
    env given the player phase's ``fall_states``), the resume of its
    checkpoint and one more epoch, then ``check_minibatch`` on the first
    agent. Returns the epoch records and the fall states."""
    return _in_temp_dir("smoke_train_", lambda out_dir: _train(card, rows, fall_states,
                                                               out_dir))


def _check_resumed(saved, resumed):
    """Raise Failed unless ``resumed`` holds ``saved``'s weights, Adam
    moments and steps, normalizers (with the AMP one where the agent has
    it) and epoch, bit for bit."""
    import torch

    names = [n for n, _ in saved.network.named_parameters()]
    for name, p, q in zip(names, saved.network.parameters(), resumed.network.parameters()):
        sp, sq = saved.optimizer.state[p], resumed.optimizer.state[q]
        same = (torch.equal(p, q) and torch.equal(sp["exp_avg"], sq["exp_avg"])
                and torch.equal(sp["exp_avg_sq"], sq["exp_avg_sq"])
                and float(sp["step"]) == float(sq["step"]))
        if not same:
            raise Failed(f"resume: {name} or its Adam state differs from the saved agent's")
    for rms in ("obs_rms", "value_rms", "amp_rms")[:3 if hasattr(saved, "amp_rms") else 2]:
        for f in ("mean", "var", "count"):
            if not torch.equal(getattr(getattr(saved, rms), f), getattr(getattr(resumed, rms), f)):
                raise Failed(f"resume: {rms}.{f} differs from the saved agent's")
    if resumed.epoch != saved.epoch or resumed.frame != saved.frame:
        raise Failed(f"resume: epoch {resumed.epoch}, frame {resumed.frame}; saved "
                     f"{saved.epoch}, {saved.frame}")


def _train(card, rows, fall_states, out_dir):
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.ops import chol

    argv = TRAIN_ARGV + ["--output_path", out_dir]
    agent, _, _ = run.build_agent(argv)
    agent.env._fall_states = fall_states          # the player phase's drop: env construction
    t0 = time.time()
    env_state = agent.setup_training()
    torch.cuda.synchronize()
    print(f"train setup: {time.time() - t0:.1f} s (demo buffer fill, initial reset; the player "
          f"phase's fall states reused); widths {_train_widths(agent)}", flush=True)
    before = [p.detach().clone() for p in agent.network.parameters()]
    records = []

    def on_epoch(rec):
        rec["launches"] = dict(chol.LAUNCHES)
        chol.reset_launches()
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        m = rec["metrics"]
        chol_ms = sum(n * rows[k]["cold_ms"] for k, n in rec["launches"].items())
        print(f"train epoch {rec['epoch']}: wall {rec['wall_s']:.2f} s (rollout "
              f"{rec['rollout_s']:.2f} s, update {rec['update_s']:.2f} s), "
              f"{rec['env_steps_per_s']:.1f} env-steps/s; " + ", ".join(
                  f"{k} {m[k]:.4f}" for k in ("a_loss", "c_loss", "disc_loss", "enc_loss",
                                               "diversity_loss", "kl"))
              + f"; launches {rec['launches']}, Cholesky kernels ~{chol_ms:.1f} ms "
              f"({100 * chol_ms / 1e3 / rec['wall_s']:.3f}% of the epoch; an estimate: "
              f"launches x cold_ms, no trace); "
              f"peak device memory {rec['peak_gib']:.2f} GiB ({card})", flush=True)
        records.append(rec)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chol.reset_launches()
    env_state, _ = agent.train(env_state=env_state, on_epoch=on_epoch)
    if len(records) != TRAIN_EPOCHS:
        raise Failed(f"trained {len(records)} epochs, want {TRAIN_EPOCHS}")

    # save and resume: the run's final checkpoint into a new agent
    saved = os.path.join(out_dir, "Humanoid.ckpt.npz")
    t0 = time.time()
    resumed, _, _ = run.build_agent(argv + ["--resume", "1", "--checkpoint", saved,
                                            "--max_iterations", str(TRAIN_EPOCHS + 1)])
    resumed.env._fall_states = agent.env._fall_states   # env construction, not train state
    env_resumed = resumed.setup_training()
    resumed.resume(saved)
    _check_resumed(agent, resumed)
    torch.cuda.synchronize()
    print(f"resume: {os.path.getsize(saved) / 2 ** 20:.1f} MiB checkpoint; new agent built, set "
          f"up and restored in {time.time() - t0:.1f} s; weights, Adam moments and steps, "
          f"normalizers and epoch bit-equal to the saved agent's", flush=True)
    torch.cuda.reset_peak_memory_stats()
    chol.reset_launches()
    env_resumed, _ = resumed.train(env_state=env_resumed, on_epoch=on_epoch)
    if len(records) != TRAIN_EPOCHS + 1 or records[-1]["epoch"] != TRAIN_EPOCHS:
        raise Failed(f"the resumed agent trained epochs {[r['epoch'] for r in records]}")
    if not bool(torch.isfinite(env_resumed.obs).all()):
        raise Failed("non-finite observations after the resumed epoch")
    del resumed, env_resumed
    for rec in records:
        bad = [k for k, v in rec["metrics"].items() if not math.isfinite(v)]
        if bad:
            raise Failed(f"epoch {rec['epoch']}: non-finite metrics {bad}")
        want = {"chol_forward2": TRAIN_LAUNCHES, "back_solve": TRAIN_LAUNCHES, "chol_forward": 0}
        if rec["launches"] != want:
            raise Failed(f"epoch {rec['epoch']}: launches {rec['launches']}, want {want} "
                         f"(32 steps x 2 ticks x 2 substeps; the engine never calls chol_forward)")
    moved = sum(float((p.detach() - q).abs().max()) > 0
                for p, q in zip(agent.network.parameters(), before))
    if moved < len(before):
        raise Failed(f"training changed {moved} of {len(before)} weight tensors")
    norms = torch.linalg.norm(agent.roll_state["ase_latents"], dim=-1)
    if float((norms - 1).abs().max()) > 1e-4:
        raise Failed("ASE latents are not unit-norm after training")
    if not bool(torch.isfinite(env_state.obs).all()):
        raise Failed("non-finite observations after training")
    check_minibatch(agent)
    return records, agent.env._fall_states


def _twin(agent, device, z, dtype=None):
    """A copy of ``agent``'s network, normalizers and hyperparameters on
    ``device`` (in ``dtype`` if given) with a fresh Adam, whose diversity
    draw returns ``z``."""
    import copy

    import torch

    twin = copy.copy(agent)
    twin.device = torch.device(device)
    twin.network = copy.deepcopy(agent.network).to(device, dtype)
    twin.obs_rms = copy.deepcopy(agent.obs_rms).to(device, dtype)
    twin.amp_rms = copy.deepcopy(agent.amp_rms).to(device, dtype)
    twin.optimizer = twin._make_optimizer()
    twin._draw_diversity_latents = lambda n: z.to(device, dtype)
    return twin


def _gate_mlps(net, gates=None):
    """Make every relu of ``net``'s MLPs record its pre-activation, in call
    order, into the returned list. With ``gates`` (such a list's signs, in
    the same order) each relu applies the given gate in place of its
    pre-activation's own sign: pre x gate, which has relu's value and first
    and second derivatives when the gates are the pre-activations' own."""
    import types

    from ase_tpu_torch.models.networks import MLP

    pres = []
    given = None if gates is None else iter(gates)

    def forward(self, x):
        for layer in self.layers:
            pre = layer(x)
            pres.append(pre.detach())
            gate = pre > 0 if given is None else next(given).to(pre.device)
            x = pre * gate.to(pre.dtype)
        return x

    for m in net.modules():
        if isinstance(m, MLP):
            m.forward = types.MethodType(forward, m)
    return pres


def _minibatch_case(agent, rows, seed):
    """A minibatch of ``rows`` rows in the agent's dataset layout, made on
    the CPU from ``seed`` near the agent's own policy (ratios on both sides
    of the clip), and the diversity draw; returns (mb, z_div)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    n, A, L = rows, agent.action_dim, agent._latent_dim

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    z = randn(n, L)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    obs = randn(n, agent.obs_dim) * 2 + 0.5
    z_div = randn(n, L)
    base = _twin(agent, "cpu", z_div)
    with torch.no_grad():
        mu, log_sigma = base.network.eval_actor(base.obs_rms.normalize(obs), z)
        actions = mu + 0.05 * randn(n, A)
        neglogp = base._neglogp(actions, mu, log_sigma) + 0.15 * randn(n)
    mb = {"obs_n": obs, "actions": actions, "neglogp": neglogp, "values": randn(n, 1),
          "returns": randn(n, 1), "advantages": randn(n), "mu": mu + 0.01 * randn(n, A),
          "sigma": log_sigma.clone(), "rand_action_mask": (torch.rand(n, generator=gen) < 0.7).float(),
          "amp_obs": randn(n, agent.amp_obs_dim), "amp_obs_replay": randn(n, agent.amp_obs_dim),
          "amp_obs_demo": randn(n, agent.amp_obs_dim), "ase_latents": z}
    return mb, z_div


def _cotangent_l1(net):
    """Record, for every bfloat16 dense layer of ``net``, the sum over rows
    (and calls) of |cotangent at its output| in float32, keyed by its bias
    parameter's name, into the returned dict as the backward runs."""
    from ase_tpu_torch.models.networks import Dense

    out = {}

    def forward_hook(name):
        def hook(module, inputs, y):
            if y.requires_grad:
                def grad_hook(g):
                    s = g.detach().float().abs().reshape(-1, g.shape[-1]).sum(0).cpu().double()
                    out[name] = out.get(name, 0) + s
                y.register_hook(grad_hook)
        return hook

    for name, m in net.named_modules():
        if isinstance(m, Dense) and m.compute_dtype is not None:
            m.register_forward_hook(forward_hook(f"{name}.bias"))
    return out


def _update_twin(agent, mb, z_div, dev, dtype, gates=None):
    """One ``_update_minibatch`` of ``mb`` by a twin of ``agent`` on
    ``dev`` (its parameters in ``dtype``; None keeps them and the network's
    compute dtype), its relus on ``gates`` if given. Returns its losses,
    gradients, old and new weights (float64, CPU), relu pre-activations,
    the bf16 layers' cotangent sums (``_cotangent_l1``) and Adam's lr and
    eps."""
    import torch

    twin = _twin(agent, dev, z_div, dtype)
    twin._amp_minibatch_size = mb["obs_n"].shape[0]
    pres = _gate_mlps(twin.network, gates)
    l1 = _cotangent_l1(twin.network)
    params = list(twin.network.parameters())
    old = [p.detach().cpu().double() for p in params]
    metrics = twin._update_minibatch({k: v.to(dev, dtype) for k, v in mb.items()})
    if gates is not None and len(pres) != len(gates):
        raise Failed(f"minibatch check: {len(pres)} relu calls on {dev}, {len(gates)} given gates")
    (group,) = twin.optimizer.param_groups
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": [torch.zeros_like(o) if p.grad is None else p.grad.detach().cpu().double()
                      for p, o in zip(params, old)],
            "old": old, "new": [p.detach().cpu().double() for p in params],
            "pres": [x.cpu().double() for x in pres], "cot_l1": l1,
            "lr": group["lr"], "eps": group["eps"]}


def _policy_means(agent, mb, z_div, dev):
    """The policy means a minibatch update of ``mb`` on ``dev`` computes
    (after its normalizer updates), on the CPU."""
    import torch

    twin = _twin(agent, dev, z_div)
    twin._amp_minibatch_size = mb["obs_n"].shape[0]
    with torch.no_grad():
        pm = twin._preproc_minibatch({k: v.to(dev) for k, v in mb.items()})
        return twin._actor_sigma(pm["obs_n"], pm)[0].cpu()


def check_minibatch(agent, rows=256, seed=0, device="cuda"):
    """One minibatch update (normalizer updates, PPO + discriminator +
    encoder + diversity losses, backward, Adam step) of ``rows`` rows from
    ``agent``'s weights, on ``device`` and on the CPU in float32, with the
    same batch and draws, against a float64 witness on the CPU.

    A relu pre-activation within rounding of 0 may open on one side and not
    on the other, which changes that sample's backward through every layer
    below it; at the full widths that happens about once a minibatch. So
    the witness runs with its own relu gates and both float32 sides run with
    the witness's gates, and the check first shows that each side's own
    gates differ from them only where the witness's pre-activation is
    within MB_GATE_RTOL of that layer's largest. Then it raises Failed
    unless: every loss agrees card vs CPU to MB_LOSS_RTOL of max(1, |loss|);
    every gradient, before the Adam step, agrees with the witness's to
    MB_GRAD_RTOL of its tensor's largest magnitude on both sides; each
    side's new weights are its old ones less Adam's first step from its own
    gradients, lr x g / (|g| + eps), to MB_STEP_ATOL x lr (and one float32
    ulp); and the new weights agree card vs CPU to MB_W_ATOL x lr wherever
    the witness's |g| exceeds MB_W_GMIN of its tensor's largest (below
    that, the first step lr x sign(g) takes the sign of rounding noise).
    Returns the largest relative loss error, the largest gradient error
    relative to its tensor and the gate differences per side."""
    import torch

    mb, z_div = _minibatch_case(agent, rows, seed)

    def update(dev, dtype, gates=None):
        return _update_twin(agent, mb, z_div, dev, dtype, gates)

    wit = update("cpu", torch.float64)
    gates = [x > 0 for x in wit["pres"]]
    sides = {"card": update(device, torch.float32, gates), "cpu": update("cpu", torch.float32, gates)}
    names = [name for name, _ in agent.network.named_parameters()]
    f32_ulp = torch.finfo(torch.float32).eps

    flips = {}
    for side, out in sides.items():
        flips[side] = 0
        for i, (pre, pre64) in enumerate(zip(out["pres"], wit["pres"])):
            off = (pre > 0) != gates[i]
            flips[side] += int(off.sum())
            if bool(off.any()):
                near = float(pre64[off].abs().max()) / max(float(pre64.abs().max()), 1e-30)
                if not near <= MB_GATE_RTOL:
                    raise Failed(f"minibatch relu call {i} on the {side} side: a gate differs from "
                                 f"the witness's at a pre-activation {near:.3g} of the layer's largest")

    loss_err = 0.0
    for k, ref in sides["cpu"]["metrics"].items():
        got = sides["card"]["metrics"][k]
        e = abs(got - ref) / max(1.0, abs(ref))
        if not e <= MB_LOSS_RTOL:
            raise Failed(f"minibatch {k}: card {got} vs CPU {ref}")
        loss_err = max(loss_err, e)

    grad_err = (0.0, "")
    for i, name in enumerate(names):
        g64 = wit["grads"][i]
        scale = max(float(g64.abs().max()), 1e-30)
        for side, out in sides.items():
            e = float((out["grads"][i] - g64).abs().max()) / scale
            if not e <= MB_GRAD_RTOL:
                raise Failed(f"minibatch gradient of {name} on the {side} side: {e:.3g} of its "
                             f"largest from the float64 witness's (tol {MB_GRAD_RTOL})")
            grad_err = max(grad_err, (e, f"{name} ({side})"))
            lr, eps = out["lr"], out["eps"]
            g, w = out["grads"][i], out["new"][i]
            want = out["old"][i] - lr * g / (g.abs() + eps)
            over = (w - want).abs() - (MB_STEP_ATOL * lr + f32_ulp * w.abs())
            if bool((over > 0).any()):
                raise Failed(f"minibatch Adam step of {name} on the {side} side: "
                             f"{float((w - want).abs().max()) / lr:.3g} x lr from lr x g / (|g| + eps)")
        big = g64.abs() > MB_W_GMIN * scale
        dw = (sides["card"]["new"][i] - sides["cpu"]["new"][i]).abs()[big]
        if dw.numel() and not float(dw.max()) <= MB_W_ATOL * sides["cpu"]["lr"]:
            raise Failed(f"minibatch weights {name}: card vs CPU {float(dw.max()) / sides['cpu']['lr']:.3g}"
                         f" x lr where |g| > {MB_W_GMIN} of its largest (tol {MB_W_ATOL} x lr)")
    # what the gates do: both sides again, each with its own gates (not asserted)
    own = {"card": update(device, torch.float32), "cpu": update("cpu", torch.float32)}
    own_flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(own["card"]["pres"], own["cpu"]["pres"]))
    off = {name: int(((own["card"]["new"][i] - own["cpu"]["new"][i]).abs()
                      > MB_W_ATOL * own["cpu"]["lr"]).sum()) for i, name in enumerate(names)}
    print(f"  minibatch check, each side on its own relu gates: {own_flips} gates differ card vs CPU; "
          f"new weights beyond {MB_W_ATOL} x lr card vs CPU: "
          + (", ".join(f"{k} {v}" for k, v in off.items() if v) or "none"), flush=True)
    print(f"  minibatch check ({rows} rows): losses within {loss_err:.3g} (tol {MB_LOSS_RTOL}); "
          f"gradients within {grad_err[0]:.3g} of their tensor's largest from the float64 witness "
          f"(tol {MB_GRAD_RTOL}; worst {grad_err[1]}); relu gates differing from the witness's: "
          f"card {flips['card']}, CPU {flips['cpu']} of {sum(x.numel() for x in gates)}", flush=True)
    return loss_err, grad_err[0], flips


def train_bf16_phase(card, rows, fall_states):
    """TRAIN_BF16_EPOCHS epoch of ``ase_tpu_torch.run``'s training branch
    with the shipped ase_humanoid.yaml under ``mixed_precision: true``, then
    ``check_minibatch_bf16``. Returns the epoch records."""
    return _in_temp_dir("smoke_bf16_", lambda out_dir: _train_bf16(card, rows, fall_states,
                                                                    out_dir))


def _train_bf16(card, rows, fall_states, out_dir):
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.ops import chol

    def bf16(cfg, cfg_train):
        cfg_train["params"]["config"]["mixed_precision"] = True

    t0 = time.time()
    agent, _, _ = run.build_agent(TRAIN_ARGV + ["--max_iterations", str(TRAIN_BF16_EPOCHS),
                                                "--output_path", out_dir, "--horizon_length",
                                                str(CUT_HORIZON)], edit_cfg=bf16)
    agent.env._fall_states = fall_states          # the train phase's drop: env construction
    env_state = agent.setup_training()
    torch.cuda.synchronize()
    widths = _train_widths(agent, CUT_HORIZON)
    print(f"train_bf16 setup: {time.time() - t0:.1f} s (fall states reused); widths {widths}",
          flush=True)
    seen = {}

    def record(name):
        def hook(module, inputs, output):
            seen.setdefault(name, output.dtype)
        return hook

    hooks = [agent.network.actor_mlp.register_forward_hook(record("actor activation")),
             agent.network.mu.register_forward_hook(record("mu layer"))]
    before = [p.detach().clone() for p in agent.network.parameters()]
    records = []

    def on_epoch(rec):
        rec["launches"] = dict(chol.LAUNCHES)
        chol.reset_launches()
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        m = rec["metrics"]
        print(f"train_bf16 epoch {rec['epoch']}: wall {rec['wall_s']:.2f} s (rollout "
              f"{rec['rollout_s']:.2f} s, update {rec['update_s']:.2f} s), "
              f"{rec['env_steps_per_s']:.1f} env-steps/s; " + ", ".join(
                  f"{k} {m[k]:.4f}" for k in ("a_loss", "c_loss", "disc_loss", "enc_loss",
                                               "diversity_loss", "kl"))
              + f"; launches {rec['launches']}; peak device memory {rec['peak_gib']:.2f} GiB "
              f"({card})", flush=True)
        records.append(rec)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chol.reset_launches()
    env_state, _ = agent.train(env_state=env_state, on_epoch=on_epoch)
    for h in hooks:
        h.remove()
    print(f"train_bf16 dtypes on the card: {seen}; parameters "
          f"{sorted({str(p.dtype) for p in agent.network.parameters()})}", flush=True)
    if seen != {"actor activation": torch.bfloat16, "mu layer": torch.bfloat16}:
        raise Failed(f"mixed precision: the actor ran in {seen}, want bfloat16")
    if {p.dtype for p in agent.network.parameters()} != {torch.float32}:
        raise Failed("mixed precision: the parameters must stay float32")
    if len(records) != TRAIN_BF16_EPOCHS:
        raise Failed(f"trained {len(records)} bf16 epochs, want {TRAIN_BF16_EPOCHS}")
    for rec in records:
        bad = [k for k, v in rec["metrics"].items() if not math.isfinite(v)]
        if bad:
            raise Failed(f"bf16 epoch {rec['epoch']}: non-finite metrics {bad}")
        want = {"chol_forward2": CUT_LAUNCHES, "back_solve": CUT_LAUNCHES, "chol_forward": 0}
        if rec["launches"] != want:
            raise Failed(f"bf16 epoch {rec['epoch']}: launches {rec['launches']}, want {want}")
    moved = sum(float((p.detach() - q).abs().max()) > 0
                for p, q in zip(agent.network.parameters(), before))
    if moved < len(before):
        raise Failed(f"bf16 training changed {moved} of {len(before)} weight tensors")
    if not bool(torch.isfinite(env_state.obs).all()):
        raise Failed("non-finite observations after bf16 training")
    check_minibatch_bf16(agent)
    return records


def check_minibatch_bf16(agent, rows=256, seed=0, device="cuda"):
    """One minibatch update of ``rows`` rows from ``agent``'s weights under
    mixed precision (bfloat16 dense layers, float32 parameters, heads and
    losses) on ``device`` and on the CPU, with the same batch and draws.

    Both sides accumulate their products in float32 and round each layer's
    output to bfloat16, in different summation orders, so an output within
    a float32 rounding of a bf16 rounding boundary lands on neighbouring
    bf16 values (2^-8 to 2^-7 apart, relative) on the two sides, and that
    moves the layers after it. Three consequences shape the check:

    * a head output may differ by a bf16 ulp or two: the policy means are
      held to MB16_FWD_RTOL (2^-6) of their largest;
    * a relu pre-activation near 0 may open on one side only, which moves
      that sample's backward through every layer below it: the card runs
      on the CPU's own relu gates, after the check has shown that its own
      gates differ from them only where the CPU's pre-activation is within
      MB16_GATE_RTOL of the layer's largest;
    * the PPO ratio divides the action error by sigma^2 (~3e-3), so a mean
      one bf16 ulp apart moves a row's log-ratio by ~0.05 and can cross
      the clip, where the row's whole contribution switches on or off
      (sigma's gradient, a sum of such rows with much cancellation, moved
      by a third of its largest in one run): rows whose means differ in
      any element leave the actor, bound and diversity terms on both sides
      (``rand_action_mask`` 0), and are counted; summation order alone
      moves the means of a few rows in a hundred, so at least half the
      rows must agree bit for bit.

    Then it raises Failed unless every loss agrees to MB16_LOSS_RTOL of
    max(1, |loss|) and every gradient, before the Adam step, to
    MB16_GRAD_RTOL of its tensor's largest magnitude (four bf16 ulps: the
    gradient GEMM's rounding and three more along a few flipped inputs),
    a bias gradient also within MB16_ROW_RTOL (two bf16 ulps) of the sum
    over rows of |cotangent| at its layer: a bias gradient is that sum with
    much cancellation, each row's cotangent an ulp or two apart on the two
    sides. The float64 witness of ``check_minibatch`` holds float32 only.
    Returns the largest relative loss and gradient errors and the relu
    gates and rows that differ."""
    import torch

    if agent.network.mu.compute_dtype != torch.bfloat16:
        raise Failed("check_minibatch_bf16 needs an agent built with mixed_precision: true")
    mb, z_div = _minibatch_case(agent, rows, seed)
    mu_cpu, mu_card = (_policy_means(agent, mb, z_div, d) for d in ("cpu", device))
    mu_err = float((mu_card - mu_cpu).abs().max()) / max(float(mu_cpu.abs().max()), 1e-30)
    if not mu_err <= MB16_FWD_RTOL:
        raise Failed(f"bf16 minibatch policy means: card vs CPU {mu_err:.3g} of their largest "
                     f"(tol {MB16_FWD_RTOL})")
    same = (mu_card == mu_cpu).all(-1)
    if int(same.sum()) < rows // 2:
        raise Failed(f"bf16 minibatch: the policy means differ in {rows - int(same.sum())} of "
                     f"{rows} rows")
    mb = {**mb, "rand_action_mask": mb["rand_action_mask"] * same.to(torch.float32)}
    cpu = _update_twin(agent, mb, z_div, "cpu", None)
    gates = [x > 0 for x in cpu["pres"]]
    own = _update_twin(agent, mb, z_div, device, None)
    flips = 0
    for i, (pre, ref) in enumerate(zip(own["pres"], cpu["pres"])):
        off = (pre > 0) != gates[i]
        flips += int(off.sum())
        if bool(off.any()):
            near = float(ref[off].abs().max()) / max(float(ref.abs().max()), 1e-30)
            if not near <= MB16_GATE_RTOL:
                raise Failed(f"bf16 minibatch relu call {i}: a card gate differs from the CPU's "
                             f"at a pre-activation {near:.3g} of the layer's largest")
    card = _update_twin(agent, mb, z_div, device, None, gates)
    loss_err = 0.0
    for k, ref in cpu["metrics"].items():
        got = card["metrics"][k]
        e = abs(got - ref) / max(1.0, abs(ref))
        if not e <= MB16_LOSS_RTOL:
            raise Failed(f"bf16 minibatch {k}: card {got} vs CPU {ref}")
        loss_err = max(loss_err, e)
    errs = []
    for (name, _), g_cpu, g_card in zip(agent.network.named_parameters(), cpu["grads"],
                                        card["grads"]):
        scale = max(float(g_cpu.abs().max()), 1e-30)
        tol = MB16_GRAD_RTOL * scale + MB16_ROW_RTOL * cpu["cot_l1"].get(name, 0.0)
        err = (g_card - g_cpu).abs()
        errs.append((float((err / tol).max()), float(err.max()) / scale, name))
    errs.sort(reverse=True)
    print("  bf16 minibatch gradients, card vs CPU (worst 6; error over its bound, of its "
          "tensor's largest): " + ", ".join(f"{n} {r:.3g}, {e:.3g}" for r, e, n in errs[:6]),
          flush=True)
    bad = [n for r, _, n in errs if not r <= 1.0]
    if bad:
        raise Failed(f"bf16 minibatch gradients card vs CPU beyond their bounds: {', '.join(bad)}")
    grad_err = max(e for _, e, _ in errs)
    print(f"  bf16 minibatch check ({rows} rows): policy means within {mu_err:.3g} of their "
          f"largest (tol {MB16_FWD_RTOL:.3g}), {rows - int(same.sum())} rows apart in some "
          f"element left the actor terms; losses within {loss_err:.3g} (tol "
          f"{MB16_LOSS_RTOL:.3g}); gradients within {grad_err:.3g} of their tensor's largest; "
          f"card relu gates differing from the CPU's: {flips} of "
          f"{sum(x.numel() for x in gates)}", flush=True)
    return loss_err, grad_err, flips


def dr_phase(card):
    """DR_EPOCHS ASE training epoch under domain randomization (HumanoidAMP
    on humanoid_ase_sword_shield.yaml, the shipped ase_humanoid.yaml,
    ``--randomize`` with ``dr_block()``) at 4096 envs through the
    constructors ``run.build_agent`` uses; the launch counts, every knob
    away from its base in some env, and one control step profiled with
    the knobs on and off. Returns (epoch records, agent, env state)."""
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.ops import chol

    def block(cfg, cfg_train):
        cfg["task"]["randomization_params"] = dr_block()

    def train(out_dir):
        t0 = time.time()
        agent, _, _ = run.build_agent(DR_ARGV + ["--output_path", out_dir], edit_cfg=block)
        env = agent.env
        if not env._dr.enabled or len(env._dr.specs) != 7 or env.num_envs != DR_ENVS:
            raise Failed(f"dr: randomizer {env._dr.enabled}, knobs {list(env._dr.specs)}")
        env_state = agent.setup_training()
        torch.cuda.synchronize()
        print(f"dr setup: {time.time() - t0:.1f} s", flush=True)
        records = []

        def on_epoch(rec):
            rec["launches"] = dict(chol.LAUNCHES)
            chol.reset_launches()
            m = rec["metrics"]
            print(f"dr epoch {rec['epoch']}: wall {rec['wall_s']:.2f} s (rollout "
                  f"{rec['rollout_s']:.2f} s, update {rec['update_s']:.2f} s), "
                  f"{rec['env_steps_per_s']:.1f} env-steps/s; " + ", ".join(
                      f"{k} {m[k]:.4f}" for k in ("a_loss", "c_loss", "disc_loss", "kl"))
                  + f"; launches {rec['launches']} ({card})", flush=True)
            records.append(rec)

        torch.cuda.synchronize()
        chol.reset_launches()
        env_state, _ = agent.train(env_state=env_state, on_epoch=on_epoch)
        return agent, env_state, records

    agent, env_state, records = _in_temp_dir("smoke_dr_", train)
    env = agent.env
    if len(records) != DR_EPOCHS:
        raise Failed(f"trained {len(records)} dr epochs, want {DR_EPOCHS}")
    want = {"chol_forward2": CUT_LAUNCHES, "back_solve": CUT_LAUNCHES, "chol_forward": 0}
    for rec in records:
        if rec["launches"] != want:
            raise Failed(f"dr epoch {rec['epoch']}: launches {rec['launches']}, want {want}")
        bad = [k for k, v in rec["metrics"].items() if not math.isfinite(v)]
        if bad:
            raise Failed(f"dr epoch {rec['epoch']}: non-finite metrics {bad}")
    aux = env_state.aux
    summary = []
    for knob, base in (("friction_scale", 1.0), ("mass_scale", 1.0), ("stiffness_scale", 1.0),
                       ("damping_scale", 1.0), ("gravity_scale", 1.0), ("actor_scale", 1.0),
                       ("restitution", env._plane_restitution)):
        v = aux["dr_" + knob]
        if not bool((v != base).any()) or not bool(torch.isfinite(v).all()):
            raise Failed(f"dr: {knob} never left its base {base}")
        summary.append(f"{knob} {float(v.min()):.3f}..{float(v.max()):.3f}")
    count = aux["dr_count"]
    if int(count.min()) < 1 or not bool(torch.isfinite(env_state.obs).all()):
        raise Failed(f"dr: dr_count min {int(count.min())}, or non-finite observations")
    print(f"dr knobs after the epoch: {'; '.join(summary)}; dr_count {int(count.min())}.."
          f"{int(count.max())}, {float((count > 1).float().mean()):.4f} of envs reset in the "
          f"epoch; step_count {float(aux['dr_step_count']):.0f}", flush=True)

    carry = [env_state]

    def step():
        st = env.reset_done(carry[0])
        mu, _ = agent._actor_sigma(agent.obs_rms.normalize(st.obs), agent.roll_state)
        carry[0] = env.step(st, mu)

    with torch.no_grad():
        on = _profile("HumanoidAMP, domain randomization on", step, card)
        env._dr.enabled = False
        try:
            off = _profile("HumanoidAMP, the same step with the randomizer off", step, card)
        finally:
            env._dr.enabled = True
    if on is not None and off is not None:
        print(f"dr: {on:.0f} kernel launches per control step with the knobs, {off:.0f} "
              f"without ({on - off:+.0f})", flush=True)
    return records, agent, carry[0]


def dr_check_phase(agent, env_state):
    """check_tick on DR_CHECK_ENVS envs with every knob away from its base
    (the knobs their resets drew), card against CPU."""
    import torch
    from ase_tpu_torch.envs.humanoid import _dr_scales

    env = agent.env
    idx = torch.arange(DR_CHECK_ENVS, device=env_state.obs.device)
    knobs = {k: v[idx] for k, v in env._engine_knobs(_dr_scales(env_state.aux)).items()}
    if set(knobs) != {"friction_scale", "gain_scale", "mass_scale", "gravity_scale",
                      "damping_scale", "restitution", "actor_scale"}:
        raise Failed(f"dr check: knobs {sorted(knobs)}")
    for k, v in knobs.items():
        base = env._plane_restitution if k == "restitution" else 1.0
        if not bool((v != base).all()):
            raise Failed(f"dr check: {k} at its base in one of the envs")
    st = type(env_state.phys)(*(x[idx] for x in env_state.phys))
    with torch.no_grad():
        mu, _ = agent._actor_sigma(agent.obs_rms.normalize(env_state.obs[idx]),
                                   {k: v[idx] for k, v in agent.roll_state.items()})
    act = mu.clamp(-1, 1)
    print(f"  dr check on envs {idx.tolist()}: restitution "
          f"{[round(float(x), 3) for x in knobs['restitution']]}, actor scale "
          f"{[round(float(x), 3) for x in knobs['actor_scale']]}")
    check_tick(env.model, env.sim_cfg, st,
               env._pd_action_offset[None] + env._pd_action_scale[None] * act, knobs)


def _llc_matches_checkpoint(agent):
    """Whether the HRL agent's LLC weights and normalizers equal its
    checkpoint's, bit for bit."""
    import numpy as np
    from ase_tpu_torch.learning import checkpoint

    saved = np.load(os.path.join(REPO, LLC))
    leaves = checkpoint.network_leaves(agent._llc_network, ".params")
    leaves.update(checkpoint.rms_leaves(agent._llc_obs_rms, ".obs_rms"))
    leaves.update(checkpoint.rms_leaves(agent._llc_amp_rms, ".extra['amp_rms']"))
    return all(np.array_equal(leaf.get(), saved[k]) for k, leaf in leaves.items())


def strike_profile_phase(player, card):
    """``profile_phase`` over one strike control step: a decision cut to
    one LLC step (the HLC's forward, then one control step with the prop),
    as tracing a whole decision's ~120k launches took 53 s."""
    agent = player.agent
    llc_steps, agent._llc_steps = agent._llc_steps, 1
    try:
        profile_phase(player, card)
    finally:
        agent._llc_steps = llc_steps


def strike_check_phase(player):
    """check_tick on 8 strike envs: their state after the run and the LLC's
    actions for their last latent."""
    import torch

    env, agent = player.env, player.agent
    st = type(player.env_state.phys)(*(x[:8] for x in player.env_state.phys))
    with torch.no_grad():
        act = agent._compute_llc_action(player.env_state.obs[:8], player.last_actions[:8])
    contacts = (player.env_state.contact_forces[:8, env.model.nb].abs().sum(-1) > 0).sum()
    print(f"  strike check: {int(contacts)} of 8 targets in contact after the run")
    check_tick(env.model, env.sim_cfg, st,
               env._pd_action_offset[None] + env._pd_action_scale[None] * act)


def hrl_train_phase(card, rows):
    """HRL_TRAIN_EPOCHS epochs of ``run.py``'s training branch on strike,
    then the resume of its checkpoint into a new agent. Returns the epoch
    records."""
    return _in_temp_dir("smoke_hrl_", lambda out_dir: _hrl_train(card, rows, out_dir))


def _hrl_train(card, rows, out_dir):
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.ops import chol

    argv = STRIKE_ARGV + ["--max_iterations", str(HRL_TRAIN_EPOCHS), "--output_path", out_dir,
                          "--horizon_length", str(HRL_TRAIN_HORIZON)]
    t0 = time.time()
    agent, _, _ = run.build_agent(argv)
    got = {"hlc": [l.out_features for l in agent.network.actor_mlp.layers],
           "critic": [l.out_features for l in agent.network.critic_mlp.layers],
           "obs": agent.obs_dim, "latent": agent.action_dim, "llc_steps": agent._llc_steps,
           "minibatch": agent.minibatch_size, "mini_epochs": agent.mini_epochs,
           "minibatches": agent.num_minibatches, "envs": agent.num_actors,
           "horizon": agent.horizon_length}
    want = {"hlc": [1024, 512], "critic": [1024, 512], "obs": 268, "latent": 64, "llc_steps": 5,
            "minibatch": 16384, "mini_epochs": 6, "minibatches": HRL_TRAIN_HORIZON // 4,
            "envs": 4096, "horizon": HRL_TRAIN_HORIZON}
    if got != want:
        raise Failed(f"hrl_train phase not at the shipped widths: {got}")
    if not _llc_matches_checkpoint(agent):
        raise Failed("hrl_train: the LLC differs from its checkpoint before training")
    env_state = agent.setup_training()
    torch.cuda.synchronize()
    print(f"hrl_train setup: {time.time() - t0:.1f} s; widths {got}", flush=True)
    before = [p.detach().clone() for p in agent.network.parameters()]
    records = []

    def on_epoch(rec):
        rec["launches"] = dict(chol.LAUNCHES)
        chol.reset_launches()
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        m = rec["metrics"]
        chol_ms = sum(n * rows[k]["cold_ms"] for k, n in rec["launches"].items())
        print(f"hrl_train epoch {rec['epoch']}: wall {rec['wall_s']:.2f} s (rollout "
              f"{rec['rollout_s']:.2f} s, update {rec['update_s']:.2f} s), "
              f"{rec['env_steps_per_s']:.1f} decisions x envs/s, "
              f"{agent._llc_steps * rec['env_steps_per_s']:.1f} env-steps/s; " + ", ".join(
                  f"{k} {m[k]:.4f}" for k in ("a_loss", "c_loss", "b_loss", "kl", "reward_mean",
                                               "disc_reward_mean", "game_reward_mean",
                                               "consecutive_successes_mean"))
              + f"; launches {rec['launches']}, Cholesky kernels ~{chol_ms:.1f} ms (launches x "
              f"cold_ms); peak device memory {rec['peak_gib']:.2f} GiB ({card})", flush=True)
        records.append(rec)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    chol.reset_launches()
    env_state, _ = agent.train(env_state=env_state, on_epoch=on_epoch)
    if len(records) != HRL_TRAIN_EPOCHS:
        raise Failed(f"hrl_train: trained {len(records)} epochs, want {HRL_TRAIN_EPOCHS}")
    for rec in records:
        bad = [k for k, v in rec["metrics"].items() if not math.isfinite(v)]
        if bad:
            raise Failed(f"hrl_train epoch {rec['epoch']}: non-finite metrics {bad}")
        want = {"chol_forward2": HRL_TRAIN_LAUNCHES, "back_solve": HRL_TRAIN_LAUNCHES,
                "chol_forward": 0}
        if rec["launches"] != want:
            raise Failed(f"hrl_train epoch {rec['epoch']}: launches {rec['launches']}, want {want}")
    moved = sum(float((p.detach() - q).abs().max()) > 0
                for p, q in zip(agent.network.parameters(), before))
    if moved < len(before):
        raise Failed(f"hrl_train changed {moved} of {len(before)} HLC weight tensors")
    if not _llc_matches_checkpoint(agent):
        raise Failed("hrl_train: the LLC changed during training")
    if not bool(torch.isfinite(env_state.obs).all()):
        raise Failed("hrl_train: non-finite observations after training")

    saved = os.path.join(out_dir, "Humanoid.ckpt.npz")
    t0 = time.time()
    resumed, _, _ = run.build_agent(argv + ["--resume", "1", "--checkpoint", saved])
    resumed.setup_training()
    resumed.resume(saved)
    _check_resumed(agent, resumed)
    if not _llc_matches_checkpoint(resumed):
        raise Failed("hrl_train: the resumed agent's LLC differs from its checkpoint")
    torch.cuda.synchronize()
    print(f"hrl_train resume: {os.path.getsize(saved) / 2 ** 20:.1f} MiB checkpoint (the HLC's "
          f"train state; the LLC reloads from {LLC}); new agent built, set up and restored in "
          f"{time.time() - t0:.1f} s; HLC weights, Adam moments and steps, normalizers and "
          f"epoch bit-equal to the saved agent's", flush=True)
    return records


def perturb_phase(card):
    """The ASE player with the shipped LLC on HumanoidPerturb at 4096 envs
    for PERTURB_STEPS control steps; returns the launch counts and the
    player."""
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.ops import chol

    t0 = time.time()
    player, _ = run.build_player(PERTURB_ARGV)
    env = player.env
    if (env.model.num_props, env.num_envs) != (13, 4096):
        raise Failed(f"perturb: {env.model.num_props} props at {env.num_envs} envs")
    state = env.initial_state()
    torch.cuda.synchronize()
    print(f"perturb setup: {time.time() - t0:.1f} s", flush=True)
    chol.reset_launches()
    t0 = time.time()
    stats = player.run(num_steps=PERTURB_STEPS, max_chunks=1, env_state=state)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(chol.LAUNCHES)
    print(f"perturb player stats: {stats}")
    print(f"launches on the perturb path: {launches}", flush=True)
    want = {"chol_forward2": PERTURB_LAUNCHES, "back_solve": PERTURB_LAUNCHES, "chol_forward": 0}
    if launches != want:
        raise Failed(f"perturb launches {launches}, want {want} ({PERTURB_STEPS} control steps "
                     "x 2 ticks x 2 substeps)")
    es = player.env_state
    for what, t in (("obs", es.obs), ("actions", player.last_actions),
                    ("projectiles", es.phys.prop_pos)):
        if not bool(torch.isfinite(t).all()):
            raise Failed(f"perturb: non-finite {what}")
    nu = env.model.nu
    speed = es.phys.u[:, nu:].reshape(4096, 13, 6)[..., 0:3].norm(dim=-1)
    fallen = ((es.body_pos[..., 2] < env._termination_heights) & env._contact_mask).any(-1)
    hit = (es.contact_forces[:, env.model.nb:env.model.nb + 2].abs().sum(-1) > 0).any(-1)
    print(f"perturb: {env.num_envs * PERTURB_STEPS / dt:.1f} env-steps/s over {PERTURB_STEPS} "
          f"control steps x {env.num_envs} envs ({dt:.2f} s); envs still above their "
          f"termination heights {1 - float(fallen.float().mean()):.4f}; projectiles 0 and 1 "
          f"launched: mean speed {float(speed[:, :2].mean()):.2f} m/s, in contact in "
          f"{float(hit.float().mean()):.4f} of envs ({card})", flush=True)
    return launches, player


def perturb_check_phase(player):
    """check_tick on 8 perturb envs whose first or second projectile is in
    contact or within 2 m of the torso and moving."""
    import torch

    env, es = player.env, player.env_state
    nb, nu = env.model.nb, env.model.nu
    near = (es.phys.prop_pos[:, :2] - es.body_pos[:, 1:2]).norm(dim=-1) < 2.0
    moving = es.phys.u[:, nu:nu + 12].reshape(-1, 2, 6)[..., 0:3].norm(dim=-1) > 0.5
    touching = es.contact_forces[:, nb:nb + 2].abs().sum(-1) > 0
    idx = torch.nonzero((touching | (near & moving)).any(-1))[:8, 0]
    if idx.numel() < 8:
        raise Failed(f"perturb check: only {idx.numel()} envs with a projectile in play")
    print(f"  perturb check on envs {idx.tolist()}: "
          f"{int(touching[idx].any(-1).sum())} with a projectile in contact")
    st = type(es.phys)(*(x[idx] for x in es.phys))
    act = player.last_actions[idx].clamp(-1, 1)
    check_tick(env.model, env.sim_cfg, st,
               env._pd_action_offset[None] + env._pd_action_scale[None] * act)


def pgs_phase(card):
    """The ASE player with the shipped LLC on HumanoidAMP at PGS_ENVS envs, built
    twice through ``run.build_player``: with ``solverScheme: pgs`` set by
    ``edit_cfg``, then as shipped (block-Jacobi), each for PGS_STEPS control
    steps after its initial reset. The PGS run launches no Cholesky kernel,
    the Jacobi run PGS_JACOBI_LAUNCHES of chol_forward2 and back_solve;
    obs, actions and rewards stay finite, except, on the PGS run, in envs
    whose contact solve diverged (an impulse past PGS_DIVERGED or
    non-finite): the reference's PGS sweep has no divergence guard and
    diverges on such states as the port does
    (tests/test_torch_pgs.py::test_pgs_divergence_matches_reference); at
    most PGS_DIVERGED_SHARE of the envs may. Returns (the PGS run's
    launches, the PGS player, its envs whose solve diverged)."""
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.ops import chol
    from ase_tpu_torch.physics import solver

    def pgs(cfg, cfg_train):
        cfg["env"]["solverScheme"] = "pgs"

    peak = None               # per env, the largest impulse of the run (inf once non-finite)
    pgs_iterate = solver._pgs_iterate

    def watched(*args):
        lam = pgs_iterate(*args)
        m = lam.abs().amax(dim=(1, 2))
        torch.maximum(peak, torch.where(torch.isfinite(m), m, torch.full_like(m, math.inf)),
                      out=peak)
        return lam

    rates, per_step, out = {}, {}, {}
    for scheme, edit, n in (("pgs", pgs, 0), ("jacobi", None, PGS_JACOBI_LAUNCHES)):
        t0 = time.time()
        player, _ = run.build_player(PGS_ARGV + ["--num_envs", str(PGS_ENVS)], edit_cfg=edit)
        env = player.env
        if env.sim_cfg.solver.scheme != scheme or env.num_envs != PGS_ENVS:
            raise Failed(f"pgs phase: scheme {env.sim_cfg.solver.scheme} at {env.num_envs} envs")
        state = env.initial_state()
        torch.cuda.synchronize()
        setup = time.time() - t0
        if peak is None:
            peak = torch.zeros(PGS_ENVS, device=env.device)
        chol.reset_launches()
        solver._pgs_iterate = watched
        t0 = time.time()
        try:
            player.run(num_steps=PGS_STEPS, max_chunks=1, env_state=state)
            torch.cuda.synchronize()
        finally:
            solver._pgs_iterate = pgs_iterate
        dt = time.time() - t0
        launches = dict(chol.LAUNCHES)
        want = {"chol_forward2": n, "back_solve": n, "chol_forward": 0}
        if launches != want:
            raise Failed(f"{scheme} launches {launches}, want {want}")
        # the Jacobi run exempts no env
        exempt = ~(peak <= PGS_DIVERGED) if scheme == "pgs" else torch.zeros_like(peak).bool()
        es = player.env_state
        for what, t in (("obs", es.obs), ("actions", player.last_actions),
                        ("rewards", player.last_rewards.reshape(PGS_ENVS, -1))):
            bad = ~torch.isfinite(t).all(dim=-1)
            if bool((bad & ~exempt).any()):
                raise Failed(f"{scheme}: non-finite {what} in envs whose contact solve did not "
                             f"diverge: {torch.nonzero(bad & ~exempt)[:8, 0].tolist()}")
        if scheme == "pgs":
            diverged = exempt
            share = float(diverged.float().mean())
            print(f"pgs: the contact solve diverged in {int(diverged.sum())} of {PGS_ENVS} envs "
                  f"({share:.4f}; envs {torch.nonzero(diverged)[:8, 0].tolist()}), "
                  f"{int((~torch.isfinite(es.obs).all(-1)).sum())} of them non-finite after "
                  f"the run; the largest impulse of the other envs' solves "
                  f"{float(peak[~diverged].max()):.4g} N s", flush=True)
            if share > PGS_DIVERGED_SHARE:
                raise Failed(f"pgs: the contact solve diverged in {share:.4f} of the envs")
        rates[scheme] = env.num_envs * PGS_STEPS / dt
        print(f"{scheme}: {rates[scheme]:.1f} env-steps/s over {PGS_STEPS} control steps x "
              f"{env.num_envs} envs ({dt:.2f} s; setup {setup:.1f} s); launches {launches} "
              f"({card})", flush=True)
        per_step[scheme] = profile_phase(player, card)
        out[scheme] = (launches, player)
        del player, env, es
    print(f"pgs / jacobi env-steps/s: {rates['pgs']:.1f} / {rates['jacobi']:.1f} = "
          f"{rates['pgs'] / rates['jacobi']:.4f} in one call ({card})", flush=True)
    if None not in per_step.values():
        print(f"pgs / jacobi kernel launches per control step: {per_step['pgs']:.0f} / "
              f"{per_step['jacobi']:.0f} ({per_step['pgs'] - per_step['jacobi']:+.0f})", flush=True)
    return out["pgs"] + (diverged,)


def pgs_check_phase(player, diverged):
    """check_tick under the PGS scheme on the first PGS_CHECK_ENVS of the
    PGS player's envs whose contact solve did not diverge: their state
    after the run and the targets of the player's last actions (a
    diverging sweep turns rounding into impulses past PGS_DIVERGED; the
    reference diverges there too)."""
    import torch

    env, es = player.env, player.env_state
    idx = torch.nonzero(~diverged)[:PGS_CHECK_ENVS, 0]
    st = type(es.phys)(*(x[idx] for x in es.phys))
    _, tgt = env.pre_physics_step(es, player.last_actions[idx].clamp(-1, 1))
    check_tick(env.model, env.sim_cfg, st, tgt)


def viewmotion_phase(card):
    """``run.build_player`` with ``--test --task HumanoidViewMotion`` (the
    ASE player's configs, checkpoint and dataset) at VIEW_ENVS envs for
    VIEW_STEPS control steps after its initial reset: exactly VIEW_LAUNCHES
    of chol_forward2 and back_solve, none of chol_forward; body positions
    finite and at or above -0.1 m (the reference's tests/test_env.py).
    Then ``check_viewmotion``. Returns the launches."""
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.ops import chol

    t0 = time.time()
    player, _ = run.build_player(VIEW_ARGV + ["--num_envs", str(VIEW_ENVS)])
    env = player.env
    if env.control_freq_inv != 1 or not env.sim_cfg.torque_control or env.num_envs != VIEW_ENVS:
        raise Failed(f"viewmotion: control_freq_inv {env.control_freq_inv}, torque control "
                     f"{env.sim_cfg.torque_control}, {env.num_envs} envs")
    state = env.initial_state()
    torch.cuda.synchronize()
    setup = time.time() - t0
    chol.reset_launches()
    t0 = time.time()
    player.run(num_steps=VIEW_STEPS, max_chunks=1, env_state=state)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(chol.LAUNCHES)
    want = {"chol_forward2": VIEW_LAUNCHES, "back_solve": VIEW_LAUNCHES, "chol_forward": 0}
    if launches != want:
        raise Failed(f"viewmotion launches {launches}, want {want} ({VIEW_STEPS} control steps "
                     "x 1 tick x 2 substeps)")
    es = player.env_state
    low = float(es.body_pos[..., 2].min())
    if not bool(torch.isfinite(es.body_pos).all()) or low < -0.1:
        raise Failed(f"viewmotion: body positions non-finite or below -0.1 m (min z {low:.4f})")
    print(f"viewmotion: {env.num_envs * VIEW_STEPS / dt:.1f} env-steps/s over {VIEW_STEPS} "
          f"control steps x {env.num_envs} envs ({dt:.2f} s; setup {setup:.1f} s); min body z "
          f"{low:.4f} m; clips {int(es.aux['motion_ids'].min())}..{int(es.aux['motion_ids'].max())}"
          f"; launches {launches} ({card})", flush=True)

    check_viewmotion(player)
    return launches


def check_viewmotion(player, device="cuda"):
    """One view-motion control step (reset pass, step) on VIEW_CHECK_ENVS of
    the player's envs, copied from the card into players built on
    ``device`` and on the CPU: motion ids equal, body positions within
    TICK_POS_TOL. Then VIEW_QUERIES random queries of the motion library
    (the frames every reset and demo fetch reads): dof positions and the
    FK body positions of those frames, card against CPU, within
    TICK_POS_TOL. Near-identical frames take slerp's small-angle branch,
    which a one-ulp change of the frames' dot product can flip: summed by a
    reduction, whose order differs on the card, one step put a view-motion
    env's bodies 7.49e-4 m apart, card against CPU."""
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.motion import motion_lib as ml
    from ase_tpu_torch.physics import dynamics2

    n, es = VIEW_CHECK_ENVS, player.env_state
    idx = torch.arange(n, device=es.obs.device)
    out = {}
    for dev in dict.fromkeys((device, "cpu")):
        p, _ = run.build_player(VIEW_ARGV + ["--num_envs", str(n), "--device", dev])
        st = p.env.reset_done(_env_state_to(es, idx, dev))
        out[dev] = p.env.step(st, player.last_actions[:n].to(dev))
    if not torch.equal(out[device].aux["motion_ids"].cpu(), out["cpu"].aux["motion_ids"]):
        raise Failed("viewmotion check: card and CPU play different clips")
    err = (out[device].body_pos.cpu() - out["cpu"].body_pos).abs().amax(dim=(1, 2))
    print(f"  viewmotion check on {n} envs: body positions max abs err {float(err.max()):.3g} "
          f"(tol {TICK_POS_TOL}), {int((out['cpu'].reset_buf > 0).sum())} envs at a clip's end")
    if not float(err.max()) <= TICK_POS_TOL:
        raise Failed(f"viewmotion check: card and CPU disagree on body positions: envs "
                     f"{torch.nonzero(err > TICK_POS_TOL)[:, 0].tolist()}, max {float(err.max())}")

    gen = torch.Generator().manual_seed(0)
    lib = player.env._motion_lib
    ids = torch.randint(0, lib.num_motions, (VIEW_QUERIES,), generator=gen)
    times = torch.rand(VIEW_QUERIES, generator=gen) * lib.lengths.cpu()[ids]
    out = {}
    for dev in dict.fromkeys((device, "cpu")):
        env = player.env if dev == device else p.env
        ms = ml.get_motion_state(env._motion_lib, ids.to(dev), times.to(dev))
        kin = dynamics2.fk_batched(env.model, env._tables.dyn, env._ref_state_phys(ms))
        out[dev] = (ms["dof_pos"].cpu(), kin.body_pos.cpu())
    e_dof = float((out[device][0] - out["cpu"][0]).abs().max())
    e_pos = (out[device][1] - out["cpu"][1]).abs().amax(dim=(1, 2))
    print(f"  motion library, {VIEW_QUERIES} random queries: dof positions max abs err "
          f"{e_dof:.3g}, their body positions {float(e_pos.max()):.3g} (tol {TICK_POS_TOL}), "
          f"{int((e_pos > TICK_POS_TOL).sum())} queries beyond it")
    if not float(e_pos.max()) <= TICK_POS_TOL:
        raise Failed(f"motion library: card and CPU disagree on {int((e_pos > TICK_POS_TOL).sum())}"
                     f" of {VIEW_QUERIES} queries, by up to {float(e_pos.max())} m")


def savevideo_phase(card, hrl_rate):
    """``run.main`` with HRL_ARGV and ``--save_video`` at 4096 envs for
    HRL_DECISIONS decisions: the player keeps env 0's body positions and
    heading markers after each decision on the card and copies them to the
    host once per chunk. The renderer receives exactly HRL_DECISIONS
    frames with finite markers, the last bit-equal to the player's final
    state; the run launches exactly SAVEVIDEO_LAUNCHES of chol_forward2 and
    back_solve. Its env-steps/s is printed beside the hrl phase's. Where
    matplotlib imports, the video file must be written; where it does not,
    that is printed and nothing is rendered (the CPU tests hold the
    rendering). Returns the launches."""
    import importlib.util

    import numpy as np
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.ops import chol
    from ase_tpu_torch.viz import plotter

    can_render = importlib.util.find_spec("matplotlib") is not None
    seen = {}
    build, render = run.build_player, plotter.render_rollout

    def build_and_time(argv, edit_cfg=None):
        player, cfg = build(argv, edit_cfg)
        play = player.run

        def timed(**kw):
            state = player.env.initial_state()
            torch.cuda.synchronize()
            chol.reset_launches()
            seen["t0"] = time.time()
            return play(env_state=state, **kw)

        player.run = timed
        seen["player"] = player
        return player, cfg

    def record(parents, body_pos, **kw):
        torch.cuda.synchronize()
        seen["t_steps"] = time.time() - seen["t0"]
        seen["launches"] = dict(chol.LAUNCHES)
        seen.update(parents=parents, body_pos=body_pos, **kw)
        if not can_render:
            return kw["save_path"] + " (not rendered: matplotlib does not import)"
        t0 = time.time()
        written = render(parents, body_pos, **kw)
        seen["t_render"] = time.time() - t0
        seen["size"] = os.path.getsize(written) if os.path.exists(written) else 0
        return written

    def play(out_dir):
        run.main(HRL_ARGV + ["--num_envs", "4096", "--save_video",
                             os.path.join(out_dir, "heading.mp4")],
                 num_steps=HRL_DECISIONS, max_chunks=1)

    run.build_player, plotter.render_rollout = build_and_time, record
    try:
        _in_temp_dir("smoke_video_", play)
    finally:
        run.build_player, plotter.render_rollout = build, render
    player = seen["player"]
    frames, markers = seen["body_pos"], seen["markers"]
    if frames.shape != (HRL_DECISIONS, player.env.model.nb, 3):
        raise Failed(f"savevideo: {frames.shape} frames, want ({HRL_DECISIONS}, "
                     f"{player.env.model.nb}, 3)")
    if set(markers) != {"tar_dir", "tar_facing_dir"} or not all(
            m.shape == (HRL_DECISIONS, 2) and np.isfinite(m).all() for m in markers.values()):
        raise Failed(f"savevideo: markers {({k: v.shape for k, v in markers.items()})}, want "
                     "finite tar_dir and tar_facing_dir, one a frame")
    if not np.array_equal(frames[-1], player.env_state.body_pos[0].cpu().numpy()):
        raise Failed("savevideo: the last frame is not the player's final state of env 0")
    launches = seen["launches"]
    want = {"chol_forward2": SAVEVIDEO_LAUNCHES, "back_solve": SAVEVIDEO_LAUNCHES,
            "chol_forward": 0}
    if launches != want:
        raise Failed(f"savevideo launches {launches}, want {want}")
    rate = player.env.num_envs * HRL_DECISIONS * player.agent._llc_steps / seen["t_steps"]
    if can_render:
        if not seen["size"] > 0:
            raise Failed("savevideo: no video file was written")
        video = f"video rendered in {seen['t_render']:.2f} s ({seen['size']} bytes)"
    else:
        video = ("matplotlib does not import on this host: no video rendered, the capture "
                 "checked (the CPU tests hold the rendering)")
    print(f"savevideo: {rate:.1f} env-steps/s against the hrl phase's {hrl_rate:.1f} "
          f"(ratio {rate / hrl_rate:.4f}) over {HRL_DECISIONS} decisions x "
          f"{player.agent._llc_steps} control steps x {player.env.num_envs} envs "
          f"({seen['t_steps']:.2f} s); {HRL_DECISIONS} frames, launches {launches}; {video} "
          f"({card})", flush=True)
    return launches


def mocap_phase(card):
    """The mocap workflow in a temporary directory: ``tools.fbx_importer``
    on the vendored CMU clip at 60 fps (bit-equal to the vendored import),
    ``tools.retarget_motion`` onto the AMP humanoid, ``skeleton.fk`` of
    the retargeted clip on the card against ``np_fk`` and
    ``global_to_local`` of it against the input rotations; then HumanoidAMP
    (humanoid.yaml, 15 bodies, nu = 34) on that clip at MOCAP_ENVS envs
    behind ``VecEnv``: ``reset()``, MOCAP_STEPS steps of random actions
    (exactly MOCAP_LAUNCHES of chol_forward2 and back_solve, at n = 34),
    finite observations, a demo fetch; then ``check_vec_step``. Returns the
    launches."""
    return _in_temp_dir("smoke_mocap_", lambda out_dir: _mocap(card, out_dir))


def _mocap(card, out_dir):
    import numpy as np
    import torch
    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.envs.vec_env import VecEnv
    from ase_tpu_torch.motion import motion_lib as ml
    from ase_tpu_torch.motion import skeleton as sk
    from ase_tpu_torch.ops import chol
    from ase_tpu_torch.tools import fbx_importer, retarget_motion
    from ase_tpu_torch.utils import config as cfg_util

    t0 = time.time()
    imported = os.path.join(out_dir, "09_11_cmu.npy")
    fbx_importer.main(["--fbx", MOCAP_FBX, "--out", imported, "--fps", "60"])
    got, want = (np.load(p, allow_pickle=True).item() for p in (imported, MOCAP_IMPORTED))
    for k in ("rotation", "root_translation", "global_velocity", "global_angular_velocity"):
        if not np.array_equal(got[k]["arr"], want[k]["arr"]):
            raise Failed(f"mocap: the import's {k} differs from {MOCAP_IMPORTED}")
    gtree, vtree = (sk.SkeletonTree.from_dict(d["skeleton_tree"]) for d in (got, want))
    if (gtree.node_names, gtree.parent_indices, got["fps"]) != \
            (vtree.node_names, vtree.parent_indices, want["fps"]) or \
            not np.array_equal(gtree.local_translation, vtree.local_translation):
        raise Failed(f"mocap: the import's skeleton or fps differs from {MOCAP_IMPORTED}")
    t_import = time.time() - t0
    t0 = time.time()
    clip = os.path.join(out_dir, "09_11_cmu_amp.npy")
    retarget_motion.main(["--config", RETARGET_CFG, "--source", imported, "--output", clip])
    t_retarget = time.time() - t0

    tree, lr, root, _, _, _ = ml.load_motion_npy(clip)
    grs, gts = sk.fk(tree, torch.as_tensor(lr, device="cuda"),
                     torch.as_tensor(root, device="cuda"))
    back = sk.global_to_local(tree, grs).cpu().numpy()
    ngr, ngt = sk.np_fk(tree, lr, root)
    e_pos = float(np.abs(gts.cpu().numpy() - ngt).max())
    e_rot = float(np.abs(grs.cpu().numpy() - ngr).max())
    sign = np.where(np.sum(back * lr, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    e_back = float(np.abs(back * sign - lr).max())
    print(f"mocap: import {t_import:.2f} s ({got['rotation']['arr'].shape[0]} frames, "
          f"{got['rotation']['arr'].shape[1]} joints, bit-equal "
          f"to {MOCAP_IMPORTED}), retarget {t_retarget:.2f} s ({lr.shape[0]} frames, "
          f"{lr.shape[1]} joints); fk on the card vs np_fk: positions {e_pos:.3g} m (tol "
          f"{FK_POS_TOL}), rotations {e_rot:.3g}, global_to_local(fk) vs the input {e_back:.3g} "
          f"(tol {FK_ROT_TOL})", flush=True)
    if not (e_pos <= FK_POS_TOL and e_rot <= FK_ROT_TOL and e_back <= FK_ROT_TOL):
        raise Failed(f"mocap: fk on the card off np_fk or the input rotations: {e_pos}, "
                     f"{e_rot}, {e_back}")

    t0 = time.time()
    cfg, _ = cfg_util.load_cfg(cfg_util.get_args(MOCAP_ARGV + ["--motion_file", clip]))
    env = parse_task(cfg["name"], cfg, device="cuda")
    vec = VecEnv(env)
    torch.cuda.synchronize()
    setup = time.time() - t0
    if (env.model.nb, env.model.nu, env.num_envs) != (15, 34, MOCAP_ENVS):
        raise Failed(f"mocap: {env.model.nb} bodies, nu = {env.model.nu}, {env.num_envs} envs")
    gen = torch.Generator(device="cuda").manual_seed(0)
    na = env.get_action_size()
    chol.reset_launches()
    t0 = time.time()
    obs = vec.reset()
    for _ in range(MOCAP_STEPS):
        actions = torch.rand(MOCAP_ENVS, na, generator=gen, device="cuda") * 2 - 1
        obs, rew, done, info = vec.step(actions)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(chol.LAUNCHES)
    demo = vec.fetch_amp_obs_demo(MOCAP_ENVS)
    want = {"chol_forward2": MOCAP_LAUNCHES, "back_solve": MOCAP_LAUNCHES, "chol_forward": 0}
    if launches != want:
        raise Failed(f"mocap launches {launches}, want {want} ({MOCAP_STEPS} steps x 2 ticks "
                     "x 2 substeps; the reset steps no engine)")
    amp = env.amp_obs_size()
    for what, t, shape in (("obs", obs, (MOCAP_ENVS, env.get_obs_size())),
                           ("amp_obs", info["amp_obs"], (MOCAP_ENVS, amp)),
                           ("demo", demo, (MOCAP_ENVS, amp)), ("rewards", rew, (MOCAP_ENVS,))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise Failed(f"mocap: {what} of shape {tuple(t.shape)} (want {shape}) or non-finite")
    print(f"mocap: HumanoidAMP on the retargeted clip, {MOCAP_ENVS} envs: "
          f"{MOCAP_ENVS * MOCAP_STEPS / dt:.1f} env-steps/s over {MOCAP_STEPS} steps after a "
          f"reset ({dt:.2f} s; setup {setup:.1f} s); obs {tuple(obs.shape)}, amp_obs "
          f"{tuple(info['amp_obs'].shape)}, {int(done.sum())} envs done, mean reward "
          f"{float(rew.mean()):.4f}; launches {launches} ({card})", flush=True)

    idx = torch.arange(MOCAP_CHECK_ENVS, device="cuda")
    check_vec_step(cfg, vec.state, idx, actions[:MOCAP_CHECK_ENVS])
    return launches


def check_vec_step(cfg, state, idx, actions, device="cuda"):
    """One ``VecEnv.step`` of the task ``cfg`` names on rows ``idx`` of
    ``state``, copied into adapters built from ``cfg`` on ``device`` and on
    the CPU, float32 contact solve on both sides: positions and rotations
    within TICK_POS_TOL, velocities within TICK_VEL_RTOL of their scale (as
    ``check_tick``, over one control step of ``controlFrequencyInv``
    ticks); the card's step launches chol_forward2 and back_solve once a
    substep. Returns the max errors."""
    import copy

    import torch
    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.envs.vec_env import VecEnv
    from ase_tpu_torch.ops import chol

    out = {}
    for dev in dict.fromkeys((device, "cpu")):
        c = copy.deepcopy(cfg)
        c["env"]["numEnvs"] = int(idx.shape[0])
        env = parse_task(c["name"], c, device=dev)
        env.sim_cfg = env.sim_cfg._replace(solver=env.sim_cfg.solver._replace(matvec_bf16=False))
        vec = VecEnv(env)
        vec.state = _env_state_to(state, idx, dev)
        before = dict(chol.LAUNCHES)
        vec.step(actions.to(dev))
        ticks = env.control_freq_inv * env.sim_cfg.substeps if torch.device(dev).type == "cuda" \
            else 0
        launched = {k: chol.LAUNCHES[k] - before[k] for k in before}
        if launched != {"chol_forward2": ticks, "back_solve": ticks, "chol_forward": 0}:
            raise Failed(f"VecEnv step on {dev} launched {launched}")
        out[dev] = vec.state
    errs = {}
    for name in ("root_pos", "root_quat", "joint_q", "hinge_q", "u"):
        a, b = getattr(out[device].phys, name).cpu(), getattr(out["cpu"].phys, name)
        errs[name] = float((a - b).abs().max())
        tol = TICK_VEL_RTOL * max(1.0, float(b.abs().max())) if name == "u" else TICK_POS_TOL
        print(f"  VecEnv step check {name}: max abs err {errs[name]:.3g} (tol {tol:.3g})")
        if not errs[name] <= tol:
            raise Failed(f"VecEnv step: card and CPU disagree on {name}: {errs[name]} > {tol}")
    return errs


def cache_phase(card):
    """The native motion cache: delete the dataset's cache file, build the
    extension, then load the library twice (a miss, then a hit) on the
    card. Returns (cold load s, warm load s)."""
    import dataclasses

    import torch
    import yaml
    from ase_tpu_torch import native
    from ase_tpu_torch.motion import motion_lib as ml
    from ase_tpu_torch.physics import mjcf
    from ase_tpu_torch.utils import paths

    with open(paths.data_path("cfg", "humanoid_ase_sword_shield_getup.yaml")) as f:
        env_cfg = yaml.safe_load(f)["env"]
    asset = env_cfg["asset"]
    model = mjcf.load_mjcf(mjcf.find_asset(asset["assetRoot"], asset["assetFileName"]),
                           device="cpu")
    keys = [model.body_index(b) for b in env_cfg["keyBodies"]]
    path = paths.motion_file(DATASET)
    files, weights = ml._fetch_motion_files(path)
    cpath = ml._cache_path(path, files, weights, model.dof_body_ids, model.dof_offsets)
    if os.path.exists(cpath):
        os.remove(cpath)
    t0 = time.time()
    native.motion_cache()
    t_build = time.time() - t0

    def load():
        before = dict(ml.CACHE)
        t0 = time.time()
        lib = ml.load_motion_lib(path, model.dof_body_ids, model.dof_offsets, keys,
                                 device="cuda")
        torch.cuda.synchronize()
        return lib, time.time() - t0, {k: ml.CACHE[k] - before[k] for k in before}

    cold, t_cold, counted_cold = load()
    warm, t_warm, counted_warm = load()
    if counted_cold != {"hits": 0, "misses": 1} or counted_warm != {"hits": 1, "misses": 0}:
        raise Failed(f"cache: the loads counted {counted_cold} then {counted_warm}, want a "
                     "miss then a hit")
    for f in dataclasses.fields(cold):
        a, b = getattr(cold, f.name), getattr(warm, f.name)
        same = (a.dtype == b.dtype and torch.equal(a, b)) if torch.is_tensor(a) else a == b
        if not same:
            raise Failed(f"cache: {f.name} of the hit differs from the miss's")
    print(f"motion cache: extension built in {t_build:.2f} s; {len(files)} clips, "
          f"{os.path.getsize(cpath) / 2 ** 20:.1f} MiB cache; cold load (parse + write) "
          f"{t_cold:.3f} s, warm load (map) {t_warm:.3f} s, tensors bit-equal ({card})",
          flush=True)
    return t_cold, t_warm


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multi_rank(rank, port, out_dir):
    """One rank of the multi phase, in a spawned process: join the gloo
    group on the card, set up and train one epoch through ``run``, and
    write what it counted to ``out_dir/rank<rank>.json``."""
    sys.path.insert(0, REPO)
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(MULTI_RANKS), "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    import torch
    from ase_tpu_torch import run
    from ase_tpu_torch.motion import motion_lib as ml
    from ase_tpu_torch.ops import chol
    from ase_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.init(backend="gloo", device="cuda:0")
    try:
        agent, _, _ = run.build_agent(MULTI_ARGV + ["--output_path", out_dir], mesh=mesh)
        t0 = time.time()
        env_state = agent.setup_training()
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        records = []

        def on_epoch(rec):
            rec["launches"] = dict(chol.LAUNCHES)
            records.append(rec)

        torch.cuda.reset_peak_memory_stats()
        chol.reset_launches()
        env_state, _ = agent.train(env_state=env_state, on_epoch=on_epoch)
        out = {"rank": mesh.rank, "world": mesh.world, "staged": mesh.staged,
               "envs": agent.num_actors, "setup_s": setup_s, "records": records,
               "checksum": agent.replica_checksum().tolist(), "cache": dict(ml.CACHE),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "finite_obs": bool(torch.isfinite(env_state.obs).all())}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        mesh.close()


def multi_phase(card, rates):
    """MULTI_RANKS ranks of ``multi_rank`` on the one card; ``rates`` are
    the one-rank phases' env-steps/s to print beside the global rate.
    Returns rank 0's launches."""
    def ranks(out_dir):
        ctx = multiprocessing.get_context("spawn")   # this process holds a CUDA context
        port = _free_port()
        procs = [ctx.Process(target=multi_rank, args=(r, port, out_dir))
                 for r in range(MULTI_RANKS)]
        t0 = time.time()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(1.0, BUDGET_S["multi"] - (time.time() - t0)))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * MULTI_RANKS:
            raise Failed(f"multi: rank exit codes {codes} (a negative code: killed after "
                         f"the {BUDGET_S['multi']} s budget, or by a signal)")
        out = []
        for r in range(MULTI_RANKS):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out

    results = _in_temp_dir("smoke_multi_", ranks)
    want = {"chol_forward2": CUT_LAUNCHES, "back_solve": CUT_LAUNCHES, "chol_forward": 0}
    for res in results:
        r = res["rank"]
        if (res["world"], res["staged"], res["envs"]) != (MULTI_RANKS, True,
                                                          MULTI_ENVS // MULTI_RANKS):
            raise Failed(f"multi: rank {r} ran world {res['world']}, staged {res['staged']}, "
                         f"{res['envs']} envs")
        if len(res["records"]) != 1:
            raise Failed(f"multi: rank {r} trained {len(res['records'])} epochs, want 1")
        rec = res["records"][0]
        if rec["launches"] != want:
            raise Failed(f"multi: rank {r} launched {rec['launches']}, want {want}")
        bad = [k for k, v in rec["metrics"].items() if not math.isfinite(v)]
        if bad or not res["finite_obs"]:
            raise Failed(f"multi: rank {r}: non-finite metrics {bad} or observations")
    if len({tuple(res["checksum"]) for res in results}) != 1:
        raise Failed(f"multi: replica checksums differ: {[res['checksum'] for res in results]}")
    if len({json.dumps(res["records"][0]["metrics"]) for res in results}) != 1:
        raise Failed("multi: the ranks report different metrics")
    for res in results:
        rec = res["records"][0]
        print(f"multi rank {res['rank']}: setup {res['setup_s']:.1f} s; epoch wall "
              f"{rec['wall_s']:.2f} s (rollout {rec['rollout_s']:.2f} s, update "
              f"{rec['update_s']:.2f} s); launches {rec['launches']}; peak device memory "
              f"{res['peak_gib']:.2f} GiB; motion cache {res['cache']}", flush=True)
    rec = results[0]["records"][0]
    m = rec["metrics"]
    print(f"multi: {MULTI_RANKS} ranks on one card (gloo, host-staged), {MULTI_ENVS} envs in "
          f"all: {rec['env_steps_per_s']:.1f} global env-steps/s; one rank in this call: "
          + "; ".join(f"{k} {v}" for k, v in rates.items())
          + f"; checksums bit-equal {results[0]['checksum']}; " + ", ".join(
              f"{k} {m[k]:.4f}" for k in ("a_loss", "c_loss", "disc_loss", "enc_loss", "kl"))
          + f" ({card})", flush=True)
    return rec["launches"]


def nccl_phase():
    """A world-1 NCCL group in this process through ``parallel.mesh.init()``."""
    import torch
    import torch.distributed as dist
    from ase_tpu_torch.parallel import mesh as mesh_lib

    group_vars = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                  "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in group_vars}
    os.environ.update(group_vars)
    try:
        mesh = mesh_lib.init()
        try:
            if dist.get_backend() != "nccl" or mesh.staged or mesh.device != torch.device("cuda", 0):
                raise Failed(f"nccl: backend {dist.get_backend()}, staged {mesh.staged}, "
                             f"device {mesh.device}")
            x = torch.arange(12.0, device="cuda").reshape(4, 3)
            ints = torch.tensor([[1 << 40, -3]], dtype=torch.int64, device="cuda")
            got = {"all_reduce_sum": mesh.all_reduce_sum(x), "all_gather_rows": mesh.all_gather_rows(x),
                   "broadcast": mesh.broadcast(x), "all_gather_rows int64": mesh.all_gather_rows(ints)}
            want = {"all_reduce_sum": x, "all_gather_rows": x, "broadcast": x,
                    "all_gather_rows int64": ints}
            for k, v in got.items():
                if v.device != x.device or not torch.equal(v, want[k]):
                    raise Failed(f"nccl: {k} gave {v.tolist()} on {v.device}")
            torch.cuda.synchronize()
        finally:
            mesh.close()
        if dist.is_initialized():
            raise Failed("nccl: the process group outlived destroy_process_group")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print("nccl: world-1 NCCL group: all_reduce_sum, all_gather_rows (float32, int64) and "
          "broadcast on cuda:0 as expected; group destroyed", flush=True)


ORACLE_ENVS = 4096
ORACLE_TICKS = 8
ORACLE_K = 24
ORACLE_M_RTOL = 2e-5             # oracle vs batched on the card: M and bias, of their scale
ORACLE_PHI_TOL = 1e-5            # ... Phi, absolute
ORACLE_DEPTH_TOL = 2e-5          # ... sorted contact depths, absolute
ORACLE_ATTR_TOL = 1e-4           # ... normal, position, friction at matching depth ranks
ORACLE_ATTR_SHARE = 1e-3         # ... but for this share of the compared contacts, held
ORACLE_ATTR_WIDE = 1e-3          #     to this: a deep, near-concentric self-penetration
                                 #     rounds its normal to 1e-4-4e-4 (1.01e-4 in 1 of
                                 #     2048 poses on the CPU, 3.5e-4 at worst and the
                                 #     4th worst 1.08e-4 at 4096 on the card);
                                 #     tests/test_collision_soa.py's 16 poses meet none
PENDULUM_TICKS = 1400            # tests/test_physics.py:125's swing at 600 Hz
PENDULUM_DT = 1.0 / 600.0
PENDULUM_XML = """
<mujoco model="pend">
  <worldbody>
    <body name="anchor" pos="0 0 2">
      <geom type="sphere" size="0.01" density="100"/>
      <body name="rod" pos="0 0 0">
        <joint name="swing" type="hinge" axis="0 1 0" range="-180 180"
               stiffness="0" damping="0" armature="0"/>
        <geom type="capsule" fromto="0 0 0 0 0 -1.0" size="0.02" density="1000"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""
EVALSKILLS_ARGV = ["--envs", "256", "--steps", "16", "--getup-envs", "256",
                   "--getup-steps", "32"]
EVALSKILLS_LAUNCHES = (16 + 32) * 2 * 2          # control steps x 2 ticks x 2 substeps


def _random_poses(model, B, seed, device):
    """``tests/test_dynamics2.py:22-33``'s states: root height 0.5 + U(0, 1),
    random root and joint rotations, standard-normal articulation
    velocities; the default pose otherwise."""
    import torch
    from ase_tpu_torch.ops import quat as rot
    from ase_tpu_torch.physics import dynamics

    gen = torch.Generator(device=device).manual_seed(seed)
    st = dynamics.default_state(model, B)
    root_pos = st.root_pos.clone()
    root_pos[:, 2] = 0.5 + torch.rand(B, generator=gen, device=device)
    u = st.u.clone()
    u[:, :model.nu] = torch.randn(B, model.nu, generator=gen, device=device)
    return st._replace(
        root_pos=root_pos,
        root_quat=rot.quat_unit(torch.randn(B, 4, generator=gen, device=device)),
        joint_q=rot.quat_unit(torch.randn(st.joint_q.shape, generator=gen, device=device)),
        u=u)


def _rank_matched(ref, got):
    """Differences between two contact sets at matching depth ranks
    (``tests/test_collision_soa.py:47-60``): {"depth": max over the sorted
    depths, and for "normal", "pos", "friction": (max, max over all but the
    worst ORACLE_ATTR_SHARE of the compared contacts)}, and the count of
    ranks left out of the attributes: those whose depth lies within
    ORACLE_DEPTH_TOL of zero or of a neighbour's, where the two sides may
    order or select the contacts differently."""
    import torch

    dr, oa = torch.sort(ref.depth, dim=1, descending=True, stable=True)
    dg, ob = torch.sort(got.depth, dim=1, descending=True, stable=True)
    errs = {"depth": float((dr - dg).abs().max())}
    gap = torch.full_like(dr, float("inf"))
    gap[:, 1:] = dr[:, :-1] - dr[:, 1:]
    gap[:, :-1] = torch.minimum(gap[:, :-1], dr[:, :-1] - dr[:, 1:])
    clear = (gap > ORACLE_DEPTH_TOL) & (dr.abs() > ORACLE_DEPTH_TOL)
    n = int(clear.sum())
    spare = int(ORACLE_ATTR_SHARE * n)
    for f in ("normal", "pos", "friction"):
        va, vb = getattr(ref, f), getattr(got, f)
        if va.dim() == 3:
            fa = torch.gather(va, 1, oa[..., None].expand_as(va))
            fb = torch.gather(vb, 1, ob[..., None].expand_as(vb))
            d = (fa - fb).abs().amax(-1)
        else:
            d = (torch.gather(va, 1, oa) - torch.gather(vb, 1, ob)).abs()
        d = torch.sort(d[clear]).values if n else torch.zeros(1, device=d.device)
        errs[f] = (float(d[-1]), float(d[max(0, d.numel() - 1 - spare)]))
        errs[f + " count"] = int((d > ORACLE_ATTR_TOL).sum())
    return errs, int((~clear & (dr.abs() > ORACLE_DEPTH_TOL)).sum())


def check_oracle(model, B, seed=0):
    """The AoS oracles against the batched forms the engine runs, both on
    the card, at B random poses (``tests/test_dynamics2.py``,
    ``tests/test_collision_soa.py`` and the reference's
    ``test_joint_batched_actuation_matches_loop``, at their tolerances).
    Returns the max errors."""
    import torch
    from ase_tpu_torch.ops import quat as rot
    from ase_tpu_torch.physics import collision2, collision3, dynamics, dynamics2

    dev = model.device
    st = _random_poses(model, B, seed, dev)
    static = dynamics2.DynStatic(model)
    h = 1.0 / 120.0
    errs = {}

    def hold(name, ref, got, atol, rtol=0.0):
        e = float((ref - got).abs().max())
        tol = atol + rtol * float(ref.abs().max())
        errs[name] = e
        if not e <= tol:
            raise Failed(f"oracle: {name} {e} > {tol}")

    kin = dynamics.fk(model, st)
    kb = dynamics2.fk_batched(model, static, st)
    for f, tol in (("body_quat", 1e-6), ("body_pos", 1e-5), ("body_R", 1e-5),
                   ("body_vel", 1e-4), ("com_world", 1e-5)):
        hold(f"fk {f}", getattr(kin, f), getattr(kb, f), tol)
    dyn = dynamics.compute_dynamics(model, st, kin, h)
    M_bl, bias, Phi = dynamics2.compute_dynamics_batch_last(model, static, st, kin,
                                                            static.diag(model, h))
    hold("M", dyn.Mmat, M_bl.permute(2, 0, 1), 0.0, ORACLE_M_RTOL)
    hold("bias", dyn.bias, bias, 0.0, ORACLE_M_RTOL)
    hold("Phi", dyn.Phi, Phi, ORACLE_PHI_TOL)
    tab = dynamics.dof_tables(model)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tgt = 0.4 * torch.randn(B, model.nd, generator=gen, device=dev)
    ks = 0.5 + torch.rand(B, generator=gen, device=dev)
    for kd in (None, ks):
        hold("pd_torques" + ("" if kd is None else " (damping scale)"),
             dynamics.pd_torques(model, st, tgt, h, kd_scale=1.0 if kd is None else kd),
             dynamics.pd_torques_batched(model, tab, st, tgt, h, kd_scale=kd), 1e-4, 1e-5)
    hold("limit_torques", dynamics.limit_torques(model, st),
         dynamics.limit_torques_batched(model, tab, st), 1e-4, 1e-5)

    tables = collision2.build_tables(model, True)
    aos = collision2.detect(model, tables, kin.body_R, kin.body_pos,
                            rot.quat_to_rotation_matrix(st.prop_quat), st.prop_pos, ORACLE_K)
    soa = collision3.detect_batched(collision3.DetectConsts(model, tables.soa, dev),
                                    kin.body_quat, kin.body_pos, st.prop_quat, st.prop_pos,
                                    ORACLE_K)
    cerr, left = _rank_matched(aos, soa)
    errs["contacts depth"] = cerr.pop("depth")
    over = {f: cerr.pop(f + " count") for f in ("normal", "pos", "friction")}
    if not errs["contacts depth"] <= ORACLE_DEPTH_TOL:
        raise Failed(f"oracle: contact depths {errs['contacts depth']} > {ORACLE_DEPTH_TOL}")
    for f, (worst, body) in cerr.items():
        errs[f"contacts {f}"], errs[f"contacts {f} but the worst share"] = worst, body
        if not (body <= ORACLE_ATTR_TOL and worst <= ORACLE_ATTR_WIDE):
            raise Failed(f"oracle: contact {f} {body} (all but {ORACLE_ATTR_SHARE} of them) > "
                         f"{ORACLE_ATTR_TOL} or {worst} > {ORACLE_ATTR_WIDE}")
    touching = int((aos.depth > 0).sum())
    print(f"oracle at {B} random poses on {dev}: " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items())
        + f"; {touching} penetrating contacts, {left} ranks within {ORACLE_DEPTH_TOL} of zero "
        f"or of a neighbour left out of the attributes; compared contacts past "
        f"{ORACLE_ATTR_TOL}: {over}", flush=True)
    return errs


def check_one_env_steps(model, cfg, state, actions):
    """``engine.step`` (one env, no batch dim) for len(actions) ticks on the
    card; each tick also taken on the CPU from the card's state before it,
    held at ``check_tick``'s tolerances. Returns (the card's launches of
    the run, the max errors)."""
    import torch
    from ase_tpu_torch.ops import chol
    from ase_tpu_torch.physics import engine

    cfg = cfg._replace(solver=cfg.solver._replace(matvec_bf16=False))
    mc, mh = model.to("cuda"), model.to("cpu")
    Tc, Th = engine.Tables(mc, cfg), engine.Tables(mh, cfg)
    st = type(state)(*(x.to("cuda") for x in state))
    errs = {}
    launched = {k: 0 for k in chol.LAUNCHES}
    for a in actions:
        before = dict(chol.LAUNCHES)
        out = engine.step(mc, cfg, Tc, st, a.to("cuda")).state
        for k in launched:
            launched[k] += chol.LAUNCHES[k] - before[k]
        ref = engine.step(mh, cfg, Th, type(st)(*(x.cpu() for x in st)), a.cpu()).state
        for name in ("root_pos", "root_quat", "joint_q", "hinge_q", "u"):
            a_, b_ = getattr(out, name).cpu(), getattr(ref, name)
            e = float((a_ - b_).abs().max())
            tol = TICK_VEL_RTOL * max(1.0, float(b_.abs().max())) if name == "u" else TICK_POS_TOL
            errs[name] = max(errs.get(name, 0.0), e)
            if not e <= tol:
                raise Failed(f"one-env step: card and CPU disagree on {name}: {e} > {tol}")
        st = out
    torch.cuda.synchronize()
    return launched, errs


def pendulum_model(device):
    """The reference's single-hinge pendulum (tests/test_physics.py:125): a
    fixed base, so n = nu = 1."""
    from ase_tpu_torch.physics import mjcf

    with tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False) as f:
        f.write(PENDULUM_XML)
        path = f.name
    try:
        return mjcf.load_mjcf(path, device=device)
    finally:
        os.unlink(path)


def pendulum_check(device="cuda", ticks=PENDULUM_TICKS):
    """The pendulum swung from rest at 0.1 rad for ``ticks`` ticks of
    ``engine.step``: the period within 5% of the small-angle physical
    pendulum's and the amplitude of the last 400 ticks within 10% of the
    first 400's (tests/test_physics.py:125's bounds). Returns (period,
    analytic period, late amplitude, early amplitude)."""
    import numpy as np
    import torch
    from ase_tpu_torch.physics import dynamics, engine

    m = pendulum_model(device)
    if (m.nu, m.root_dofs) != (1, 0):
        raise Failed(f"pendulum: want one hinge on a fixed base, got nu {m.nu}")
    cfg = engine.SimConfig(dt=PENDULUM_DT, substeps=1, enable_self_collision=False,
                           max_contacts=4, torque_control=True)
    T = engine.Tables(m, cfg)
    s = dynamics.set_dof_state(m, dynamics.default_state(m), torch.tensor([0.1], device=device),
                               torch.zeros(1, device=device))
    zero = torch.zeros(m.nd, device=device)
    thetas = []
    for _ in range(ticks):
        s = engine.step(m, cfg, T, s, zero).state
        thetas.append(dynamics.dof_pos(m, s)[0])
    thetas = torch.stack(thetas).cpu().numpy().astype(np.float64)
    centered = thetas - thetas.mean()
    crossings = np.where(np.diff(np.sign(centered)) != 0)[0]
    if len(crossings) < 2:
        raise Failed("pendulum did not oscillate")
    period = 2.0 * np.diff(crossings).mean() * PENDULUM_DT
    mass, com_d = float(m.mass[1]), abs(float(m.com[1][2]))
    I_p = float(m.inertia[1][1, 1]) + mass * com_d ** 2
    T_analytic = 2 * np.pi * np.sqrt(I_p / (mass * 9.81 * com_d))
    late, early = np.abs(centered[-400:]).max(), np.abs(centered[:400]).max()
    if not abs(period - T_analytic) <= 0.05 * T_analytic:
        raise Failed(f"pendulum period {period} s, analytic {T_analytic} s (5%)")
    if not abs(late - early) <= 0.1 * early:
        raise Failed(f"pendulum amplitude {late} late against {early} early (10%)")
    return period, T_analytic, late, early


def oracle_phase(card):
    """The AoS oracles against the batched engine at ORACLE_ENVS poses, the
    one-env ``engine.step`` card against CPU for ORACLE_TICKS ticks (B = 1:
    2 launches of chol_forward2 and of back_solve a tick), and the pendulum
    (n = 1) on the card. Returns the launches of the one-env run and the
    pendulum's."""
    import torch
    from ase_tpu_torch.ops import chol
    from ase_tpu_torch.physics import dynamics, engine, mjcf

    model = mjcf.load_mjcf(mjcf.find_asset("", "mjcf/amp_humanoid_sword_shield.xml"),
                           device="cuda")
    t0 = time.time()
    check_oracle(model, ORACLE_ENVS)
    torch.cuda.synchronize()
    print(f"oracle check: {time.time() - t0:.1f} s ({card})", flush=True)

    gen = torch.Generator().manual_seed(1)
    st = dynamics.default_state(model.to("cpu"))
    st = st._replace(root_pos=torch.tensor([0.0, 0.0, 0.92]),
                     u=0.3 * torch.randn(model.nv, generator=gen))
    st = dynamics.set_dof_state(model.to("cpu"), st, 0.1 * torch.randn(model.nd, generator=gen),
                                dynamics.dof_vel(model.to("cpu"), st))
    acts = [0.3 * torch.randn(model.nd, generator=gen) for _ in range(ORACLE_TICKS)]
    t0 = time.time()
    chol.reset_launches()
    launched, errs = check_one_env_steps(model, engine.SimConfig(), st, acts)
    want = {"chol_forward2": 2 * ORACLE_TICKS, "back_solve": 2 * ORACLE_TICKS, "chol_forward": 0}
    print(f"one-env engine.step, {ORACLE_TICKS} ticks from a perturbed standing pose, card "
          f"against CPU tick by tick: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; launches {launched}; {time.time() - t0:.1f} s", flush=True)
    if launched != want:
        raise Failed(f"one-env step launched {launched}, want {want}")

    t0 = time.time()
    chol.reset_launches()
    period, T_analytic, late, early = pendulum_check("cuda")
    pend = dict(chol.LAUNCHES)
    print(f"pendulum (n = 1, B = 1) on the card, {PENDULUM_TICKS} ticks: period {period:.4f} s "
          f"against {T_analytic:.4f} s analytic, amplitude {late:.5f} late against {early:.5f} "
          f"early; launches {pend}; {time.time() - t0:.1f} s ({card})", flush=True)
    if pend != {"chol_forward2": PENDULUM_TICKS, "back_solve": PENDULUM_TICKS, "chol_forward": 0}:
        raise Failed(f"pendulum launched {pend}, want {PENDULUM_TICKS} of each")
    return {k: launched[k] + pend[k] for k in launched}


def evalskills_phase(card, fall_states):
    """``tools.eval_llc_skills.main`` with the shipped LLC: EVALSKILLS_ARGV's
    latent sweep on HumanoidAMP and getup rollout from the train phase's
    fall states (no 150-tick drop). The stats must be finite, with 256
    latents and some fall states, and the launches exact. Returns the
    launches."""
    import torch
    from ase_tpu_torch.ops import chol
    from ase_tpu_torch.tools import eval_llc_skills

    def run(out_dir):
        chol.reset_launches()
        t0 = time.time()
        stats = eval_llc_skills.main(EVALSKILLS_ARGV + ["--out", os.path.join(out_dir, "s.json"),
                                                       "--device", "cuda"],
                                     fall_states=fall_states)
        torch.cuda.synchronize()
        return stats, dict(chol.LAUNCHES), time.time() - t0

    stats, launched, wall = _in_temp_dir("smoke_evalskills_", run)
    print("evalskills stats: " + json.dumps(stats), flush=True)

    def numbers(x):
        if isinstance(x, dict):
            return [v for y in x.values() for v in numbers(y)]
        return list(x) if isinstance(x, list) else [x]

    bad = [v for v in numbers(stats) if not math.isfinite(float(v))]
    if bad:
        raise Failed(f"evalskills: non-finite stats {bad}")
    if stats["n_latents"] != 256 or stats["getup"]["n_fall_states"] <= 0:
        raise Failed(f"evalskills: {stats['n_latents']} latents, "
                     f"{stats['getup']['n_fall_states']} fall states")
    want = {"chol_forward2": EVALSKILLS_LAUNCHES, "back_solve": EVALSKILLS_LAUNCHES,
            "chol_forward": 0}
    if launched != want:
        raise Failed(f"evalskills launched {launched}, want {want}")
    print(f"evalskills: {wall:.1f} s, launches {launched} ({card})", flush=True)
    return launched


def main():
    t_start = time.time()
    signal.signal(signal.SIGALRM, _timeout)
    signal.alarm(TOTAL_BUDGET_S)
    card, name = phase("device", device_phase, t_start)
    import torch

    phase("build", build_phase, t_start)
    rows = phase("kernels", kernels_phase, t_start)
    t_cold, t_warm = phase("cache", lambda: cache_phase(card), t_start)
    from ase_tpu_torch.motion import motion_lib as ml
    hits_before = ml.CACHE["hits"]
    launches, player = phase("player", lambda: player_phase(card), t_start)
    phase("profile", lambda: profile_phase(player, card), t_start)
    phase("check", lambda: check_phase(player), t_start)
    fall_states = player.env._fall_states
    del player
    torch.cuda.empty_cache()
    oracle_launches = phase("oracle", lambda: oracle_phase(card), t_start)
    torch.cuda.empty_cache()
    hrl_launches, hrl_player, hrl_rate = phase("hrl", lambda: hrl_phase(
        card, HRL_ARGV + ["--num_envs", "4096"], 258, HRL_DECISIONS, "hrl"), t_start)
    phase("hrl_check", lambda: check_hrl(hrl_player), t_start)
    del hrl_player
    torch.cuda.empty_cache()
    records, fall_states = phase("train", lambda: train_phase(card, rows, fall_states), t_start)
    torch.cuda.empty_cache()
    bf16_records = phase("train_bf16", lambda: train_bf16_phase(card, rows, fall_states),
                         t_start)
    torch.cuda.empty_cache()
    evalskills_launches = phase("evalskills", lambda: evalskills_phase(card, fall_states),
                                t_start)
    del fall_states
    torch.cuda.empty_cache()
    strike_launches, strike_player, _ = phase("strike", lambda: hrl_phase(
        card, STRIKE_ARGV + ["--test", "--checkpoint", STRIKE_HLC], 268, STRIKE_DECISIONS,
        "strike"), t_start)
    phase("strike_profile", lambda: strike_profile_phase(strike_player, card), t_start)
    phase("strike_check", lambda: strike_check_phase(strike_player), t_start)
    del strike_player
    torch.cuda.empty_cache()
    hrl_records = phase("hrl_train", lambda: hrl_train_phase(card, rows), t_start)
    torch.cuda.empty_cache()
    perturb_launches, perturb_player = phase("perturb", lambda: perturb_phase(card), t_start)
    phase("perturb_check", lambda: perturb_check_phase(perturb_player), t_start)
    del perturb_player
    torch.cuda.empty_cache()
    dr_records, dr_agent, dr_state = phase("dr", lambda: dr_phase(card), t_start)
    phase("dr_check", lambda: dr_check_phase(dr_agent, dr_state), t_start)
    del dr_agent, dr_state
    torch.cuda.empty_cache()
    pgs_launches, pgs_player, diverged = phase("pgs", lambda: pgs_phase(card), t_start)
    phase("pgs_check", lambda: pgs_check_phase(pgs_player, diverged), t_start)
    del pgs_player, diverged
    torch.cuda.empty_cache()
    view_launches = phase("viewmotion", lambda: viewmotion_phase(card), t_start)
    torch.cuda.empty_cache()
    video_launches = phase("savevideo", lambda: savevideo_phase(card, hrl_rate), t_start)
    torch.cuda.empty_cache()
    mocap_launches = phase("mocap", lambda: mocap_phase(card), t_start)
    torch.cuda.empty_cache()
    hits = ml.CACHE["hits"] - hits_before
    print(f"motion cache: {hits} later loads of the dataset in this process hit the cache "
          f"and took {t_warm:.3f} s each against {t_cold:.3f} s cold, ~{hits * (t_cold - t_warm):.2f} "
          f"s saved ({card})", flush=True)
    rates = {"train epochs (HumanoidAMPGetup)": ", ".join(
                 f"{r['env_steps_per_s']:.1f}" for r in records),
             "dr epoch (HumanoidAMP, randomized)": ", ".join(
                 f"{r['env_steps_per_s']:.1f}" for r in dr_records)}
    multi_launches = phase("multi", lambda: multi_phase(card, rates), t_start)
    phase("nccl", nccl_phase, t_start)
    signal.alarm(0)
    names = ("chol_forward2", "back_solve", "chol_forward")
    train_launches = {k: sum(r["launches"][k] for r in records) for k in names}
    hrl_train_launches = {k: sum(r["launches"][k] for r in hrl_records) for k in names}
    train_bf16_launches = {k: sum(r["launches"][k] for r in bf16_records) for k in names}
    dr_launches = {k: sum(r["launches"][k] for r in dr_records) for k in names}
    replaces = {"chol_forward2": "ase_tpu/ops/pallas_chol.py:122",
                "back_solve": "ase_tpu/ops/pallas_chol.py:145",
                "chol_forward": "ase_tpu/ops/pallas_chol.py:105"}
    # chol_forward (one right-hand side) is public API the engine does not call
    kernels = [dict(name=k, route="cuda", source="ase_tpu_torch/csrc/chol.cu",
                    replaces=replaces[k], launches=launches[k],
                    train_launches=train_launches[k], hrl_launches=hrl_launches[k],
                    strike_launches=strike_launches[k],
                    hrl_train_launches=hrl_train_launches[k],
                    perturb_launches=perturb_launches[k],
                    train_bf16_launches=train_bf16_launches[k], dr_launches=dr_launches[k],
                    multi_launches=multi_launches[k], pgs_launches=pgs_launches[k],
                    viewmotion_launches=view_launches[k], savevideo_launches=video_launches[k],
                    mocap_launches=mocap_launches[k], oracle_launches=oracle_launches[k],
                    evalskills_launches=evalskills_launches[k], on_path=k != "chol_forward",
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

"""Every shipped config builds its env in the port with the reference's
sizes (port of tests/test_configs.py): the 12 env configs with the same
plain-asset swap, their observation, action and AMP observation sizes
against the formula and against ase_tpu's env, ``num_obs`` and
``num_actions``; the train configs' algos; the plain humanoid's dof tables;
``--experiment`` as the run name through the config loader and as the
checkpoint's name after a one-epoch CLI run; and the README's list of the
``ASE_TPU_*`` variables the port reads."""

import copy
import glob
import os
import re

import numpy as np
import pytest
import yaml

from ase_tpu.envs import parse_task as jparse
from ase_tpu_torch import run
from ase_tpu_torch.envs import parse_task as tparse
from ase_tpu_torch.utils import config as C
from ase_tpu_torch.utils import paths
from tests.test_configs import CFG_TASKS, TASK_OBS
from tests.test_torch_train_cli import _argv
from tests.test_torch_train_parts import _one_torch_thread  # noqa: F401  (autouse)

REPO = paths.repo_root()


@pytest.mark.parametrize("cfg_name", sorted(CFG_TASKS))
def test_config_builds(cfg_name):
    with open(paths.data_path("cfg", cfg_name)) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = 2
    cfg["env"]["motion_file"] = paths.default_clip()
    task = CFG_TASKS[cfg_name]
    # the shipped clip is sword_shield: the plain humanoid configs build the
    # sword-shield asset against it, as tests/test_configs.py does
    if "sword_shield" not in cfg["env"]["asset"]["assetFileName"]:
        cfg["env"]["asset"]["assetFileName"] = "mjcf/amp_humanoid_sword_shield.xml"
        cfg["env"]["keyBodies"] = ["right_hand", "left_hand", "right_foot",
                                   "left_foot", "sword", "shield"]
    env = tparse(task, copy.deepcopy(cfg), device="cpu")
    ref = jparse(task, copy.deepcopy(cfg))
    base = 1 + env.model.nb * 15 - 3
    assert env.get_obs_size() == base + TASK_OBS.get(task, 0) == ref.get_obs_size()
    assert env.get_action_size() == env.model.nd == ref.get_action_size()
    assert env.num_obs == env.get_obs_size() == ref.num_obs
    assert env.num_actions == env.get_action_size() == ref.num_actions
    if hasattr(ref, "get_num_amp_obs"):
        per_step = 13 + 6 * (len(env.model.dof_offsets) - 1) + env.model.nd \
            + 3 * len(cfg["env"]["keyBodies"])
        assert env.get_num_amp_obs() == 10 * per_step == ref.get_num_amp_obs()


def test_train_configs_parse():
    """Every train config names an algo the port runs, with its config and
    network blocks."""
    algos, _ = run.build_alg_runner()
    paths_ = glob.glob(paths.data_path("cfg", "train", "rlg", "*.yaml"))
    assert paths_
    for path in paths_:
        with open(path) as f:
            params = yaml.safe_load(f)["params"]
        assert params["algo"]["name"] in algos, path
        assert "config" in params and "network" in params


def test_plain_humanoid_asset_builds():
    """The 28-dof amp_humanoid asset loads with the reference's dof tables."""
    from ase_tpu_torch.physics import mjcf

    m = mjcf.load_mjcf(mjcf.find_asset("ase/data/assets", "mjcf/amp_humanoid.xml"),
                       device="cpu")
    assert m.dof_body_ids == (1, 2, 3, 4, 6, 7, 9, 10, 11, 12, 13, 14)
    assert m.dof_offsets == (0, 3, 6, 9, 10, 13, 14, 17, 18, 21, 24, 25, 28)
    assert m.nd == 28 and m.nb == 15


def test_experiment_flag_overrides_run_name():
    """--experiment renames the run, which keys the checkpoint files."""
    base = ["--cfg_env", "humanoid_sword_shield.yaml",
            "--cfg_train", "train/rlg/amp_humanoid.yaml"]
    _, cfg_train = C.load_cfg(C.get_args(base + ["--experiment", "MyRun"]))
    assert cfg_train["params"]["config"]["name"] == "MyRun"
    _, cfg_train2 = C.load_cfg(C.get_args(base))
    assert cfg_train2["params"]["config"]["name"] == "Humanoid"


def test_experiment_names_the_checkpoint(tmp_path):
    """A one-epoch CLI run under --experiment MyRun --bench writes
    MyRun.ckpt.npz under --output_path, not the train config's name."""
    run.main(_argv(tmp_path) + ["--experiment", "MyRun", "--bench", "--max_iterations", "1",
                                "--device", "cpu"])
    out = tmp_path / "out"
    assert sorted(os.listdir(out)) == ["MyRun.ckpt.npz"]
    assert int(np.load(out / "MyRun.ckpt.npz")[".epoch"]) == 1


def test_readme_lists_every_env_var_the_port_reads():
    """Every ASE_TPU_* variable read under ase_tpu_torch/ or in chip_smoke.py
    is named in the README's port section (docs/FLAGS.md is ase_tpu's)."""
    read = re.compile(r"os\.(?:environ\.get|getenv|environ\.setdefault)\(\s*[\"'](ASE_TPU_\w+)"
                      r"|os\.environ\[\s*[\"'](ASE_TPU_\w+)")
    sources = glob.glob(os.path.join(REPO, "ase_tpu_torch", "**", "*.py"), recursive=True)
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    used = set()
    for path in sources:
        with open(path) as f:
            used.update(a or b for a, b in read.findall(f.read()))
    assert {"ASE_TPU_PROFILE", "ASE_TPU_BF16", "ASE_TPU_DATA_ROOT"} <= used
    with open(os.path.join(REPO, "README.md")) as f:
        readme = f.read()
    port = readme[readme.index("## PyTorch / H100 port"):]
    missing = sorted(v for v in used if v not in port)
    assert not missing, f"read by the port but not in the README's port section: {missing}"


def test_amp_task_config_trains_one_epoch(tmp_path):
    """amp_humanoid_task.yaml (AMP with a task reward, at its widths) on
    HumanoidHeading: one epoch through the CLI at 2 envs x 4 steps."""
    _, record = run.main([
        "--task", "HumanoidHeading", "--cfg_env", "humanoid_sword_shield_heading.yaml",
        "--cfg_train", "train/rlg/amp_humanoid_task.yaml", "--motion_file",
        paths.default_clip(), "--num_envs", "2", "--horizon_length", "4", "--minibatch_size",
        "8", "--max_iterations", "1", "--bench", "--seed", "0", "--device", "cpu",
        "--output_path", str(tmp_path)])
    assert record["epoch"] == 0
    assert all(np.isfinite(v) for v in record["metrics"].values())
    assert (tmp_path / "Humanoid.ckpt.npz").is_file()

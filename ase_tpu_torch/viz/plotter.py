"""Skeleton / motion visualization (port of ``ase_tpu/viz/plotter.py``;
reference ``ase/poselib/poselib/visualization``).

Matplotlib-3D rendering of SkeletonTree states and motion playback — offline
CPU-side tooling, same capability tier as the reference plotter (interactive
keyboard playback, bone lines + joint dots), built directly on matplotlib's
animation API instead of the reference's task/primitive indirection.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ase_tpu_torch.motion.skeleton import SkeletonTree, np_fk


def _require_matplotlib():
    try:
        import matplotlib.pyplot as plt  # noqa: F401
        return plt
    except ImportError as e:  # headless images may lack it
        raise ImportError("matplotlib is required for visualization") from e


def plot_skeleton_state(
    tree: SkeletonTree,
    local_rotation: np.ndarray,
    root_translation: np.ndarray,
    ax=None,
    show: bool = True,
):
    """Draw one pose: bones as lines, joints as dots."""
    plt = _require_matplotlib()
    grs, gts = np_fk(tree, local_rotation[None], root_translation[None])
    gts = gts[0]
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
    ax.clear()
    for j in range(tree.num_joints):
        p = tree.parent_indices[j]
        if p >= 0:
            seg = np.stack([gts[p], gts[j]])
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "b-")
    ax.scatter(gts[:, 0], gts[:, 1], gts[:, 2], c="r", s=8)
    lim = np.abs(gts).max() + 0.2
    ax.set_xlim(-lim, lim); ax.set_ylim(-lim, lim); ax.set_zlim(0, 2 * lim)
    if show:
        plt.show()
    return ax


def plot_skeleton_motion(
    tree: SkeletonTree,
    local_rotation: np.ndarray,   # (T, J, 4)
    root_translation: np.ndarray, # (T, 3)
    fps: float = 30.0,
    save_path: Optional[str] = None,
):
    """Animate a motion; optionally save to mp4/gif (requires ffmpeg/pillow).

    Interactive playback controls (reference
    ``poselib/visualization/common.py:8-182`` keyboard parity):
      space  pause/resume        r  restart
      ←/→    scrub ±1 frame      ↑/↓  scrub ±10 frames
      q      close
    """
    plt = _require_matplotlib()
    from matplotlib import animation

    grs, gts = np_fk(tree, local_rotation, root_translation)
    T = gts.shape[0]

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    lines = []
    for j in range(tree.num_joints):
        p = tree.parent_indices[j]
        if p >= 0:
            (ln,) = ax.plot([], [], [], "b-")
            lines.append((j, p, ln))
    center = gts[:, 0, :].mean(axis=0)
    ax.set_xlim(center[0] - 2, center[0] + 2)
    ax.set_ylim(center[1] - 2, center[1] + 2)
    ax.set_zlim(0, 2.2)
    title = ax.set_title("")

    state = {"frame": 0, "paused": False}

    def draw(f):
        f = int(f) % T
        for (j, p, ln) in lines:
            seg = np.stack([gts[f, p], gts[f, j]])
            ln.set_data(seg[:, 0], seg[:, 1])
            ln.set_3d_properties(seg[:, 2])
        title.set_text(f"frame {f}/{T - 1}" + ("  [paused]" if state["paused"] else ""))
        return [ln for (_, _, ln) in lines]

    def update(_):
        if not state["paused"]:
            state["frame"] = (state["frame"] + 1) % T
        return draw(state["frame"])

    def on_key(event):
        k = event.key
        if k == " ":
            state["paused"] = not state["paused"]
        elif k == "right":
            state["paused"] = True
            state["frame"] = (state["frame"] + 1) % T
        elif k == "left":
            state["paused"] = True
            state["frame"] = (state["frame"] - 1) % T
        elif k == "up":
            state["paused"] = True
            state["frame"] = (state["frame"] + 10) % T
        elif k == "down":
            state["paused"] = True
            state["frame"] = (state["frame"] - 10) % T
        elif k == "r":
            state["frame"] = 0
        elif k == "q":
            plt.close(event.canvas.figure)
            return
        draw(state["frame"])
        event.canvas.draw_idle()

    anim = animation.FuncAnimation(
        fig, update, frames=T, interval=1000.0 / fps, blit=False
    )
    if save_path:
        anim.save(save_path, fps=int(fps))
    else:
        fig.canvas.mpl_connect("key_press_event", on_key)
        plt.show()
    return anim


def render_rollout(
    parents,
    body_pos: np.ndarray,          # (T, nb, 3) simulated body positions
    markers: Optional[dict] = None,  # name -> (T, 2|3) arrays (tar_pos/tar_dir/...)
    fps: float = 30.0,
    save_path: str = "rollout.mp4",
    title: str = "",
) -> str:
    """Render a simulated rollout (one env's body positions per control step)
    to a video file — the headless replacement for watching a trained policy
    live in the reference's Isaac Gym viewer (reference base_task.py:142-164
    render loop). mp4 via OpenCV when available; .gif falls back to pillow.

    Returns the path actually written.
    """
    plt = _require_matplotlib()
    import matplotlib
    matplotlib.use("Agg", force=False)

    body_pos = np.asarray(body_pos)
    T = body_pos.shape[0]
    markers = markers or {}

    fig = plt.figure(figsize=(6.4, 4.8), dpi=100)
    ax = fig.add_subplot(111, projection="3d")

    frames = []
    for f in range(T):
        ax.clear()
        pos = body_pos[f]
        for b, p in enumerate(parents):
            if p >= 0:
                seg = np.stack([pos[p], pos[b]])
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "g-")
        ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c="k", s=8)
        root = pos[0]
        if "tar_dir" in markers:
            d = markers["tar_dir"][f]
            ax.quiver(root[0], root[1], 0.05, d[0], d[1], 0.0,
                      length=1.0, color="tab:orange")
        if "tar_facing_dir" in markers:
            d = markers["tar_facing_dir"][f]
            ax.quiver(root[0], root[1], 0.05, d[0], d[1], 0.0,
                      length=0.6, color="tab:purple")
        if "tar_pos" in markers:
            t = markers["tar_pos"][f]
            z = t[2] if t.shape[-1] > 2 else 0.0
            ax.scatter([t[0]], [t[1]], [z], c="tab:red", s=60, marker="*")
        # camera follows the root (the reference viewer's follow-cam)
        ax.set_xlim(root[0] - 1.5, root[0] + 1.5)
        ax.set_ylim(root[1] - 1.5, root[1] + 1.5)
        ax.set_zlim(0, 2.2)
        ax.set_title(f"{title} frame {f}/{T - 1}")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(buf.copy())
    plt.close(fig)

    return _write_video(frames, fps, save_path)


def _write_video(frames, fps: float, save_path: str) -> str:
    """Encode RGB frames: mp4 via cv2 if importable and the codec opens,
    else animated gif via PIL (pure-Python, always available)."""
    if save_path.endswith(".mp4"):
        try:
            import cv2
            h, w = frames[0].shape[:2]
            vw = cv2.VideoWriter(
                save_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
            if vw.isOpened():
                for fr in frames:
                    vw.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
                vw.release()
                return save_path
        except ImportError:
            pass
        save_path = save_path[:-4] + ".gif"
    from PIL import Image
    imgs = [Image.fromarray(fr) for fr in frames]
    imgs[0].save(save_path, save_all=True, append_images=imgs[1:],
                 duration=int(1000.0 / fps), loop=0)
    return save_path


def plot_env_state(env, env_state, env_id: int = 0, ax=None, show: bool = True):
    """Draw the current simulated pose of one env (body positions) plus the
    task markers the reference renders as marker actors: heading/facing
    arrows (``tar_dir``/``tar_facing_dir``), location/reach/strike targets
    (``tar_pos``). The env state may live on the card: the drawn rows are
    copied to the host."""
    plt = _require_matplotlib()

    def host(t):
        return t[env_id].detach().cpu().numpy()

    pos = host(env_state.body_pos)
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
    for b, p in enumerate(env.model.parents):
        if p >= 0:
            seg = np.stack([pos[p], pos[b]])
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "g-")
    ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c="k", s=8)

    aux = env_state.aux
    root = pos[0]
    if "tar_dir" in aux:
        d = host(aux["tar_dir"])
        ax.quiver(root[0], root[1], 0.05, d[0], d[1], 0.0,
                  length=1.0, color="tab:orange", label="tar_dir")
    if "tar_facing_dir" in aux:
        d = host(aux["tar_facing_dir"])
        ax.quiver(root[0], root[1], 0.05, d[0], d[1], 0.0,
                  length=0.6, color="tab:purple", label="tar_facing_dir")
    if "tar_pos" in aux:
        t = host(aux["tar_pos"])
        z = t[2] if t.shape[-1] > 2 else 0.0
        ax.scatter([t[0]], [t[1]], [z], c="tab:red", s=60, marker="*",
                   label="tar_pos")
    if any(k in aux for k in ("tar_dir", "tar_facing_dir", "tar_pos")):
        ax.legend(loc="upper right")
    if show:
        plt.show()
    return ax

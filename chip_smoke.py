#!/usr/bin/env python
"""Proof that the path tracer runs on a GPU, through its users' entry points.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --chips 4   # four GPUs: the sharded train step only

Runs in one process (nvidia-smi and make run as children).  Any failure
exits non-zero and prints no result line.  Phases on one card, in order:

  a. device: the first JAX device must be a GPU
  b. native build: make -C sycl_ray_tracing/native (SAH builder, OBJ parser)
  c. entry points: main.main on data/cornell_box.obj (512x512, 16 spp,
     8 bounces); train.main (3 steps, 512x512, 4 spp); pathtracer.render on
     the 200k- and 870k-triangle dragon with the HDR sky (512x512, 1 spp,
     8 bounces), forward, and forward+backward w.r.t. the diffuse albedo
     on the 200k scene
  d. the plain references, on the card: closest-hit and any-hit of 4096
     rays against chunked brute force; the 64x64 dragon image against the
     brute-force backend at the same key; a finite-difference check of the
     albedo gradient on the Cornell box
  e. numbers: compile time, forward and fwd+bwd ms (host clock around
     block_until_ready), peak device memory, next to the card's name and
     power limit

With --chips 4: make_train_step on a ("data", "sample") = (2, 2) mesh over
the 200k dragon (512x512, 2 spp, 8 bounces) against the same per-shard
step replayed shard by shard on one card.

Everything is float32; the camera transforms run at full float32
precision.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(REPO, "data", "cornell_box.obj")


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.time()
    log(f"[{name}] ...")
    yield
    log(f"[{name}] ok ({time.time() - t0:.1f} s)")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def check_device(count: int):
    """Phase a: the first JAX device is a GPU and ``count`` are present."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"needs a GPU; JAX found {devices[0].platform} devices only"
        )
    if len(devices) < count:
        raise RuntimeError(f"needs {count} GPUs; JAX found {len(devices)}")
    return devices


def build_native() -> None:
    """Phase b: build the native library and make sure it loads."""
    subprocess.run(["make", "-C", os.path.join(REPO, "sycl_ray_tracing",
                                               "native")],
                   check=True, capture_output=True, text=True)
    from sycl_ray_tracing import native

    if not native.available():
        raise RuntimeError("native library built but does not load")


def run_main(width: int, samples: int, bounces: int) -> dict:
    """main.main on the committed Cornell box; checks RT_output.hdr."""
    import numpy as np

    import main as cli
    from sycl_ray_tracing.utils.hdr import read_hdr

    rc = cli.main([CORNELL, f"--w={width}", f"--h={width}",
                   f"--samples={samples}", f"--bounces={bounces}",
                   "--camera=cornell"])
    if rc != 0:
        raise RuntimeError(f"main.main returned {rc}")
    img = read_hdr("RT_output.hdr")
    if img.shape != (width, width, 3) or not np.isfinite(img).all():
        raise RuntimeError(f"bad RT_output.hdr: shape {img.shape}")
    if not img.mean() > 0.0:
        raise RuntimeError("main.main rendered a black image")
    return {"mean": float(img.mean())}


def run_train(width: int, steps: int, samples: int) -> list:
    """train.main for a few steps; returns its printed losses (finite).
    Its return code compares errors after a full run, so it is not a
    gate here."""
    import math

    import train

    class Tee(io.StringIO):
        def __init__(self, out):
            super().__init__()
            self.out = out

        def write(self, s):
            self.out.write(s)
            return super().write(s)

    buf = Tee(sys.stdout)
    with contextlib.redirect_stdout(buf):
        train.main([f"--steps={steps}", f"--w={width}", f"--h={width}",
                    f"--samples={samples}"])
    losses = [float(x) for x in re.findall(r"loss (\S+)", buf.getvalue())]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"train losses not finite: {losses}")
    return losses


def _timed(fn, args, runs: int):
    """Median and range of ``runs`` calls, in ms (block_until_ready)."""
    import jax
    import numpy as np

    ms = []
    for _ in range(runs):
        t0 = time.time()
        jax.block_until_ready(fn(*args))
        ms.append((time.time() - t0) * 1e3)
    return float(np.median(ms)), float(min(ms)), float(max(ms))


def flagship(scene, width: int, spp: int, bounces: int, grad: bool,
             runs: int = 5) -> dict:
    """pathtracer.render on ``scene`` with the dragon camera: compile time,
    forward ms, and with ``grad`` the fwd+bwd ms of the image mean w.r.t.
    the diffuse albedo."""
    import dataclasses

    import jax
    import numpy as np

    from sycl_ray_tracing.models import pathtracer
    from sycl_ray_tracing.models.camera import pbrt_dragon_camera
    from sycl_ray_tracing.utils.config import RenderConfig

    cam = pbrt_dragon_camera()
    cfg = RenderConfig(width=width, height=width, samples=spp,
                       bounces=bounces)
    out = {"backend": pathtracer._resolve_backend(scene, cfg.intersect)}
    key = jax.random.PRNGKey(0)
    t0 = time.time()
    fwd = jax.jit(lambda s, k: pathtracer.render(s, cam, cfg, k,
                                                 with_aux=True))
    fwd = fwd.lower(scene, key).compile()
    out["fwd_compile_s"] = time.time() - t0
    img, aux = fwd(scene, key)
    img = np.asarray(img)
    if img.shape != (width, width, 3) or not np.isfinite(img).all():
        raise RuntimeError(f"bad frame: shape {img.shape}")
    if not img.mean() > 0.0:
        raise RuntimeError("black frame")
    if bool(aux["overflow"]):
        raise RuntimeError("frame reports uncertified traversal (overflow)")
    out["mean"] = float(img.mean())
    out["fwd_ms"] = _timed(fwd, (scene, key), runs)
    if grad:
        mats = scene.materials

        def loss(diffuse, k):
            s = scene.with_materials(dataclasses.replace(mats,
                                                         diffuse=diffuse))
            return pathtracer.render(s, cam, cfg, k).mean()

        t0 = time.time()
        vg = jax.jit(jax.value_and_grad(loss))
        vg = vg.lower(mats.diffuse, key).compile()
        out["bwd_compile_s"] = time.time() - t0
        val, g = vg(mats.diffuse, key)
        g = np.asarray(g)
        if not np.isfinite(g).all() or not np.abs(g).sum() > 0.0:
            raise RuntimeError("albedo gradient not finite or all zero")
        out["fwd_bwd_ms"] = _timed(vg, (mats.diffuse, key), max(1, runs - 2))
    return out


def brute_closest(ray_o, ray_d, tris, chunk: int = 8192):
    """Plain reference: closest (t, prim) over ALL triangles, a chunk of
    triangles at a time (BIG_T / -1 on miss)."""
    import jax
    import jax.numpy as jnp

    from sycl_ray_tracing.ops.intersect import BIG_T, _mt_dense_scalar

    n = tris.shape[0]
    k = -(-n // chunk)
    tris = jnp.concatenate(
        [tris, jnp.zeros((k * chunk - n, 3, 3), tris.dtype)]
    ).reshape(k, chunk, 3, 3)

    def step(carry, xs):
        best_t, best_i = carry
        c, tc = xs
        t = _mt_dense_scalar(ray_o, ray_d, tc)             # [R, chunk]
        tm = jnp.min(t, axis=1)
        i = jnp.argmin(t, axis=1).astype(jnp.int32) + c * chunk
        better = tm < best_t
        return (jnp.where(better, tm, best_t),
                jnp.where(better, i, best_i)), None

    r = ray_o.shape[0]
    init = (jnp.full((r,), BIG_T, jnp.float32), jnp.full((r,), -1, jnp.int32))
    (t, i), _ = jax.lax.scan(step, init, (jnp.arange(k), tris))
    return t, jnp.where(t < BIG_T, i, -1)


def compare_traversal(scene, width: int, n_rays: int) -> dict:
    """Closest-hit and any-hit of the scene's own tracer ("auto") against
    chunked brute force: n_rays/2 primaries of a width x width frame plus
    n_rays/2 first-bounce rays from their hits.  float32; hit masks and
    occlusion must agree exactly, t within 1e-5 relative, and prims equal
    except where two triangles tie in t."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sycl_ray_tracing.models import pathtracer
    from sycl_ray_tracing.models.camera import pbrt_dragon_camera
    from sycl_ray_tracing.ops.intersect import BIG_T
    from sycl_ray_tracing.ops.sampling import cosine_hemisphere

    half = n_rays // 2
    cols = 1 << (half.bit_length() // 2)
    rows = half // cols
    ys, xs = jnp.meshgrid(jnp.arange(rows, dtype=jnp.float32),
                          jnp.arange(cols, dtype=jnp.float32),
                          indexing="ij")
    o, d = pbrt_dragon_camera().generate_rays(
        (xs.reshape(-1) + 0.5) * (width / cols),
        (ys.reshape(-1) + 0.5) * (width / rows), width, width)
    hit0 = pathtracer.intersect_scene(scene, o, d, "brute")
    u = jax.random.uniform(jax.random.PRNGKey(7), (half, 2))
    wi, _ = cosine_hemisphere(hit0.normal, u[:, 0], u[:, 1])
    o2 = jnp.where(hit0.hit[:, None], hit0.point + 1e-4 * hit0.normal, o)
    d2 = jnp.where(hit0.hit[:, None], wi, d)
    o = jnp.concatenate([o, o2])
    d = jnp.concatenate([d, d2])

    t_ref, prim_ref = (np.asarray(a) for a in
                       jax.jit(brute_closest)(o, d, scene.triangles))
    hit = jax.jit(lambda s, o, d: pathtracer.intersect_scene(s, o, d))(
        scene, o, d)
    t, prim = np.asarray(hit.t), np.asarray(jnp.where(hit.hit, hit.prim, -1))
    m = t_ref < BIG_T
    if not ((t < BIG_T) == m).all():
        raise RuntimeError(f"hit masks differ on {((t < BIG_T) != m).sum()} "
                           f"rays")
    rel = np.abs(t[m] - t_ref[m]) / t_ref[m]
    if rel.max(initial=0.0) > 1e-5:
        raise RuntimeError(f"closest t off by {rel.max():.2e} relative")
    ties = int((prim[m] != prim_ref[m]).sum())
    if ties > max(2, len(t) // 1000):
        raise RuntimeError(f"{ties} prims differ (more than t-ties)")

    # any-hit: a limit well short of the closest hit must be clear, one
    # well past it blocked, misses always clear
    idx = np.arange(len(t_ref))
    t_max = np.where(m, np.where(idx % 2 == 0, 0.5 * t_ref, t_ref + 1.0),
                     BIG_T).astype(np.float32)
    want = m & (idx % 2 == 1)
    blocked = np.asarray(jax.jit(
        lambda s, o, d, tm: pathtracer.occluded(s, o, d, tm))(
            scene, o, d, jnp.asarray(t_max)))
    if not (blocked == want).all():
        raise RuntimeError(f"any-hit differs on {(blocked != want).sum()} "
                           f"rays")
    return {"rays": len(t), "hits": int(m.sum()), "t_ties": ties,
            "max_rel_t": float(rel.max(initial=0.0))}


def compare_image(scene, width: int, bounces: int) -> dict:
    """The scene's own tracer against the brute-force backend, same key,
    width x width, 1 spp.  A t-tie can send one path elsewhere, so 99.9%
    of pixels must agree within atol=1e-4, rtol=1e-3, and the mean
    absolute difference must stay below 1e-4."""
    import jax
    import numpy as np

    from sycl_ray_tracing.models import pathtracer
    from sycl_ray_tracing.models.camera import pbrt_dragon_camera
    from sycl_ray_tracing.utils.config import RenderConfig

    cam = pbrt_dragon_camera()
    imgs = {}
    for be in ("auto", "brute"):
        cfg = RenderConfig(width=width, height=width, samples=1,
                           bounces=bounces, intersect=be, tile_rays=None)
        imgs[be] = np.asarray(jax.jit(
            lambda s, k, cfg=cfg: pathtracer.render(s, cam, cfg, k))(
                scene, jax.random.PRNGKey(3)))
    a, b = imgs["auto"], imgs["brute"]
    if not np.isfinite(a).all() or not a.mean() > 0.0:
        raise RuntimeError("bad image from the scene's tracer")
    close = np.abs(a - b) <= 1e-4 + 1e-3 * np.abs(b)
    frac = float(close.all(axis=-1).mean())
    mad = float(np.abs(a - b).mean())
    if frac < 0.999 or mad >= 1e-4:
        raise RuntimeError(f"image vs brute: {frac:.4f} of pixels close, "
                           f"mean abs diff {mad:.2e}")
    return {"pixels_close": frac, "mean_abs_diff": mad}


def check_fd(width: int = 12, samples: int = 4, bounces: int = 2) -> dict:
    """Albedo gradient on the Cornell box through the scene's own tracer:
    jax.grad against a central finite difference of the same program,
    eps=1e-3, rtol=1e-2 (tests/test_gradients.py::test_grad_albedo)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from sycl_ray_tracing.models import pathtracer
    from sycl_ray_tracing.models.camera import cornell_box_camera
    from sycl_ray_tracing.utils.obj_loader import load_scene

    scene = load_scene(CORNELL).build_acceleration(
        num_rays_hint=width * width)
    cam = cornell_box_camera()
    key = jax.random.PRNGKey(123)
    ys, xs = jnp.meshgrid(jnp.arange(width, dtype=jnp.float32),
                          jnp.arange(width, dtype=jnp.float32),
                          indexing="ij")

    def f(shift, scene):
        mats = scene.materials
        s = scene.with_materials(
            dataclasses.replace(mats, diffuse=mats.diffuse * (1.0 + shift)))
        return jnp.mean(pathtracer.render_rays(
            s, cam, xs.reshape(-1), ys.reshape(-1), width, width, key,
            samples, bounces))

    # one compiled program serves the gradient and both FD evaluations
    vg = jax.jit(jax.value_and_grad(f))
    eps = 1e-3
    g_ad = float(vg(jnp.float32(0.0), scene)[1])
    g_fd = (float(vg(jnp.float32(eps), scene)[0])
            - float(vg(jnp.float32(-eps), scene)[0])) / (2 * eps)
    np.testing.assert_allclose(g_ad, g_fd, rtol=1e-2, atol=1e-6)
    return {"backend": pathtracer._resolve_backend(scene, "auto"),
            "grad": g_ad, "fd": g_fd}


def sharded_train_check(scene, devices, width: int, spp: int,
                        bounces: int) -> dict:
    """make_train_step on a (2, 2) ("data", "sample") mesh against the same
    per-shard step run shard by shard on one card with the same folded
    keys, losses and gradients averaged.  1e-5 relative for summation
    order."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from sycl_ray_tracing.models.camera import pbrt_dragon_camera
    from sycl_ray_tracing.parallel.mesh import make_mesh
    from sycl_ray_tracing.parallel.render import (
        make_train_step,
        shard_key,
        shard_loss_and_grads,
    )
    from sycl_ray_tracing.utils.config import RenderConfig

    mesh = make_mesh(4, sample_axis=2, devices=list(devices[:4]))
    cfg = RenderConfig(width=width, height=width, samples=spp,
                       bounces=bounces)
    cam = pbrt_dragon_camera()
    true = scene.materials
    guess = dataclasses.replace(
        true, diffuse=jnp.clip(true.diffuse + 0.1, 0.0, 1.0))
    ys, xs = jnp.meshgrid(jnp.arange(width, dtype=jnp.float32),
                          jnp.arange(width, dtype=jnp.float32),
                          indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    key = jax.random.PRNGKey(11)

    t0 = time.time()
    step = make_train_step(scene, cfg, mesh, optimize_env=False)
    loss, (g,) = step(guess, None, true, None, cam, px, py, key)
    jax.block_until_ready(g)
    sharded_s = time.time() - t0
    t0 = time.time()
    loss, (g,) = step(guess, None, true, None, cam, px, py, key)
    jax.block_until_ready(g)
    step_ms = (time.time() - t0) * 1e3

    n_data, n_sample = mesh.shape["data"], mesh.shape["sample"]
    per = px.shape[0] // n_data
    one = jax.jit(lambda px_s, py_s, k: shard_loss_and_grads(
        scene, cfg, spp // n_sample, False, guess, None, true, None, cam,
        px_s, py_s, k))
    losses, grads = [], []
    for d_idx in range(n_data):
        for s_idx in range(n_sample):
            sl = slice(d_idx * per, (d_idx + 1) * per)
            lo, (gr,) = one(px[sl], py[sl], shard_key(key, s_idx, d_idx))
            losses.append(float(lo))
            grads.append(jax.tree.map(np.asarray, gr))
    loss_ref = float(np.mean(losses))
    g_ref = jax.tree.map(lambda *x: np.mean(x, axis=0), *grads)

    np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-5)
    for got, want in zip(jax.tree.leaves(g), jax.tree.leaves(g_ref)):
        got = np.asarray(got)
        scale = float(np.abs(want).max(initial=0.0))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    return {"mesh": dict(mesh.shape), "loss": float(loss),
            "loss_ref": loss_ref, "first_call_s": sharded_s,
            "step_ms": step_ms}


def _gb(n) -> str:
    return f"{n / 2**30:.2f} GiB"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    os.chdir(REPO)
    sys.path.insert(0, REPO)

    with phase("a. device"):
        devices = check_device(args.chips)
        import jax

        from sycl_ray_tracing.utils.compile_cache import enable_compile_cache

        card = card_line()
        log(card)
        log(f"jax: {devices[0].platform} / {devices[0].device_kind} x "
            f"{len(devices)}; compile cache {enable_compile_cache()}")
    with phase("b. native build"):
        build_native()

    from sycl_ray_tracing.utils.procedural import dragon_scene

    if args.chips == 4:
        with phase("sharded train step, 4 cards"):
            scene = dragon_scene(n_tris=200_000, with_sky=True)
            r = sharded_train_check(scene, devices, width=512, spp=2,
                                    bounces=8)
            log(f"  {json.dumps(r)} | {card}")
    else:
        with phase("c. main.main on the Cornell box"):
            log(f"  {json.dumps(run_main(512, 16, 8))}")
        with phase("c. train.main"):
            log(f"  losses {run_train(512, 3, 4)}")
        with phase("c. dragon 200k: forward and fwd+bwd"):
            d200 = dragon_scene(n_tris=200_000, with_sky=True)
            r200 = flagship(d200, 512, 1, 8, grad=True)
            log(f"  {json.dumps(r200)}")
        with phase("c. dragon 870k: forward"):
            d870 = dragon_scene(n_tris=870_000, with_sky=True)
            r870 = flagship(d870, 512, 1, 8, grad=False)
            log(f"  {json.dumps(r870)}")
            del d870
        with phase("d. traversal vs chunked brute force, 4096 rays"):
            log(f"  {json.dumps(compare_traversal(d200, 512, 4096))}")
        with phase("d. 64x64 image vs brute-force backend"):
            log(f"  {json.dumps(compare_image(d200, 64, 8))}")
        with phase("d. finite-difference albedo gradient, Cornell box"):
            log(f"  {json.dumps(check_fd())}")
        with phase("e. numbers"):
            peak = devices[0].memory_stats()["peak_bytes_in_use"]
            for name, r in (("dragon 200k", r200), ("dragon 870k", r870)):
                med, lo, hi = r["fwd_ms"]
                log(f"  {name} [{r['backend']}] forward: compile "
                    f"{r['fwd_compile_s']:.1f} s, {med:.1f} ms median "
                    f"({lo:.1f}-{hi:.1f}) | {card}")
            med, lo, hi = r200["fwd_bwd_ms"]
            log(f"  dragon 200k [{r200['backend']}] fwd+bwd: compile "
                f"{r200['bwd_compile_s']:.1f} s, {med:.1f} ms median "
                f"({lo:.1f}-{hi:.1f}) | {card}")
            log(f"  peak_bytes_in_use {_gb(peak)} | {card}")

    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Render configuration: one dataclass covering every reference flag.

Replaces the reference's hand-rolled --key=value parsing (main.cpp:42-61) and
its compile-time switches (USE_BVH render_kernel.h:13, camera preset
main.cpp:107-111, DEBUG_PIXEL render_kernel.cpp:186-188) with runtime config.
Defaults match the reference: 512x512, 64 spp, 8 bounces (main.cpp:32-40).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    samples: int = 64
    bounces: int = 8
    # intersection backend: "auto" (list on a GPU / cluster elsewhere >
    # bvh > brute, by what the scene carries), "list", "cluster", "bvh",
    # "brute"
    intersect: str = "auto"
    # camera preset name (models.camera.PRESETS) — runtime, not compile-time
    camera: str = "cornell"
    # restrict render to one pixel for debugging (reference DEBUG_PIXEL)
    debug_pixel: Optional[Tuple[int, int]] = None
    # rays processed per wavefront tile; None = whole image at once.
    # Bounds the transient memory of the cluster tracer's pair expansion.
    tile_rays: Optional[int] = 32768
    # samples per scan step (accumulated in linear HDR)
    samples_per_pass: int = 1
    # estimator wiring:
    #  "shared" — one GGX sample per bounce shared by the light-MIS term,
    #             the env-MIS term and the continuation ray: 1 closest-hit +
    #             2 any-hit scene queries per bounce (fast, unbiased)
    #  "parity" — reference structure: 3 independent GGX samples, 5 scene
    #             queries per bounce (render_kernel.cpp:633-713,569-631)
    estimator: str = "shared"
    # clamp per-sample radiance (firefly suppression; None = unbiased).
    # Introduces bounded darkening bias like every production clamp.
    max_radiance: Optional[float] = None

    # rematerialize the bounce/sample scan bodies in the backward pass
    # (path-replay: O(1 sample) live memory at ~1.5-2x backward FLOPs).
    # False stores the scan residuals instead — faster backward when a
    # tile's residuals fit HBM (they do at tile_rays<=32768; ~GBs).
    remat: bool = True

    # GGX sampler: "fixed" (corrected NDF inversion, the default) or
    # "reference" (replicates the reference's missing-sqrt sampler bug,
    # render_kernel.cpp:404, for bug-for-bug image parity testing)
    ggx_sampler: str = "fixed"

    # progressive rendering: checkpoint path (resume if it exists; saved
    # after every batch) and samples per batch.  None = single-shot.
    checkpoint: Optional[str] = None
    checkpoint_batch: int = 4

    def __post_init__(self):
        if self.intersect not in ("auto", "brute", "bvh", "cluster",
                                  "list"):
            raise ValueError(f"bad intersect mode {self.intersect!r}")
        if self.estimator not in ("shared", "parity"):
            raise ValueError(f"bad estimator {self.estimator!r}")
        if self.ggx_sampler not in ("fixed", "reference"):
            raise ValueError(f"bad ggx_sampler {self.ggx_sampler!r}")
        if self.samples % self.samples_per_pass != 0:
            raise ValueError("samples must be divisible by samples_per_pass")


def parse_cli(argv) -> tuple[RenderConfig, str, str]:
    """Parse reference-style CLI args (main.cpp:42-61).

    Returns (config, obj_path, sky_path).  Flags: --sky=, --w=, --h=,
    --samples=, --bounces=, plus new --camera=, --intersect=; a positional
    argument is the OBJ path.
    """
    obj_path = "data/cornell_box.obj"
    sky_path = "data/Skyspheres/evening_road_01_puresky_2k.hdr"
    kw = {}
    for arg in argv:
        if arg.startswith("--sky="):
            sky_path = arg[len("--sky="):]
        elif arg.startswith("--w="):
            kw["width"] = int(arg[len("--w="):])
        elif arg.startswith("--h="):
            kw["height"] = int(arg[len("--h="):])
        elif arg.startswith("--samples="):
            kw["samples"] = int(arg[len("--samples="):])
        elif arg.startswith("--bounces="):
            kw["bounces"] = int(arg[len("--bounces="):])
        elif arg.startswith("--camera="):
            kw["camera"] = arg[len("--camera="):]
        elif arg.startswith("--intersect="):
            kw["intersect"] = arg[len("--intersect="):]
        elif arg.startswith("--estimator="):
            kw["estimator"] = arg[len("--estimator="):]
        elif arg.startswith("--spp-pass="):
            kw["samples_per_pass"] = int(arg[len("--spp-pass="):])
        elif arg.startswith("--checkpoint="):
            kw["checkpoint"] = arg[len("--checkpoint="):]
        elif arg.startswith("--checkpoint-batch="):
            kw["checkpoint_batch"] = int(arg[len("--checkpoint-batch="):])
        else:
            obj_path = arg
    return RenderConfig(**kw), obj_path, sky_path

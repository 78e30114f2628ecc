"""Host-side scene cache.

Building a scene costs host CPU (BC7 encode/decode of full mip chains +
atlas packing: seconds for the seeded demo, minutes for porsche-class).
The DeviceScene is pure numpy before any `.device()` call, so it pickles
once and reloads in seconds. Build time is never part of the benchmark's
timed loop (tpurast/cli.py times only render + readback), so the cache
changes iteration latency, not any reported number.

Cache key = scene name + seed + CACHE_VERSION. Bump CACHE_VERSION when
DeviceScene gains or loses fields the pickle must carry or when asset
generation or decoding changes. The cache lives in `.scene_cache` beside
the package (TPURAST_SCENE_CACHE_DIR overrides); opt out with
TPURAST_SCENE_CACHE=0.
"""

from __future__ import annotations

import logging
import os
import pathlib
import pickle

log = logging.getLogger("tpurast.device")

CACHE_DIR = os.environ.get(
    "TPURAST_SCENE_CACHE_DIR",
    str(pathlib.Path(__file__).resolve().parents[2] / ".scene_cache"),
)

CACHE_VERSION = 5

#: Scenes generated in-repo from a seed (device/seeded.py).
SEEDED_SCENES = ("seeded_demo", "seeded_hdr", "seeded_dragons64")
#: Scenes loaded from a reference data directory.
DATA_SCENES = ("demo", "porsche_class", "hdr", "dragons64")


def load_scene_cached(name: str, loader, *args, **kwargs):
    """Memoize `loader(*args, **kwargs)` on disk under `name`."""
    if os.environ.get("TPURAST_SCENE_CACHE", "1") != "1":
        return loader(*args, **kwargs)
    path = os.path.join(CACHE_DIR, f"{name}.v{CACHE_VERSION}.pkl")
    if os.path.exists(path):
        log.info("scene cache hit: %s", path)
        with open(path, "rb") as fh:
            return pickle.load(fh)
    scene = loader(*args, **kwargs)
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        # The scene must not carry device arrays (anything after
        # .device() memoizes jnp buffers onto the object).
        state = dict(scene.__dict__)
        state.pop("_device_cache", None)
        clone = type(scene).__new__(type(scene))
        clone.__dict__.update(state)
        pickle.dump(clone, fh, protocol=5)
    os.replace(tmp, path)
    return scene


def load_named_scene(name: str, data_dir: str | None = None, seed: int = 0):
    """Load one of the benchmark scenes by name, cached.

    Seeded scenes are built from `seed`; the others need `data_dir`."""
    from tpurast.device import scene as scene_mod
    from tpurast.device import seeded

    if name in SEEDED_SCENES:
        loaders = {
            "seeded_demo": seeded.load_seeded_demo_scene,
            "seeded_hdr": seeded.load_seeded_hdr_scene,
            "seeded_dragons64": seeded.load_seeded_dragons,
        }
        return load_scene_cached(f"{name}.seed{seed}", loaders[name], seed)
    if data_dir is None:
        raise ValueError(f"scene {name!r} needs a data dir")
    loaders = {
        "demo": scene_mod.load_demo_scene,
        "porsche_class": scene_mod.load_porsche_class_scene,
        "hdr": scene_mod.load_hdr_scene,
        "dragons64": lambda d: scene_mod.load_instanced_dragons(d, 64),
    }
    return load_scene_cached(name, loaders[name], data_dir)

"""Writes the `jax.random` fixtures of this directory with JAX (raw threefry
keys, `jax_threefry_partitionable` on, 32-bit mode, as JAX 0.9 defaults):

    python tests/data/torch_prng/make_fixtures.py

`manifest.json` holds, per case, the key a seed and a chain of `split` /
`fold_in` steps give, and the sha256 of the raw bytes of `jax.random.bits`,
`uniform` and `normal` at the case's shape and dtype; `normals.npz` holds the
normals themselves (as their raw uint words), which the port need only match
within a few fp32 ulps, and the bf16 packed latent of one 1024 px FLUX
candidate (`draw_packed_noise`). `tests/test_torch_threefry.py` holds the
files to live JAX and the port's `utils/threefry.py` to them on the CPU;
`chip_smoke.py` holds the port to them on the card.
"""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# name, seed, chain ("split<n>:<i>" or "fold_in:<data>"), shape, dtype
CASES = [
    ("s0_one_f32", 0, [], [1], "float32"),
    ("s1_odd_f32", 1, ["split2:1"], [7], "float32"),
    ("s42_grid_bf16", 42, ["fold_in:3"], [3, 5], "bfloat16"),
    ("s42_odd_bf16", 42, ["split4:2"], [1027], "bfloat16"),
    ("smax_chain3_f32", 2**31 - 2, ["split4:3", "fold_in:7", "split2:0"], [131075], "float32"),
    ("s7_latent_grid_f32", 7, ["split2:0", "split2:1", "fold_in:1"], [2, 17, 3, 16], "float32"),
]
LATENT = {"seed": 3, "height": 1024, "width": 1024, "channels": 16}


def chain_key(seed: int, chain: list[str]):
    key = jax.random.PRNGKey(seed)
    for step in chain:
        op, arg = step.split(":")
        if op == "fold_in":
            key = jax.random.fold_in(key, int(arg))
        else:
            key = jax.random.split(key, int(op[len("split"):]))[int(arg)]
    return key


def raw(a) -> np.ndarray:
    """The array's raw bytes as unsigned words of its width."""
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def draw(seed: int, chain: list[str], shape: list[int], dtype: str) -> dict:
    key = chain_key(seed, chain)
    dt = jnp.dtype(dtype)
    return {"key": [int(w) for w in np.asarray(key)],
            "bits": np.asarray(jax.random.bits(key, tuple(shape))),
            "uniform": raw(jax.random.uniform(key, tuple(shape), dt)),
            "normal": raw(jax.random.normal(key, tuple(shape), dt))}


def latent() -> np.ndarray:
    from reflectionflow_tpu.models.flux.latents import draw_packed_noise

    lat = draw_packed_noise(jax.random.PRNGKey(LATENT["seed"]), 1, LATENT["height"], LATENT["width"],
                            LATENT["channels"], jnp.bfloat16)
    return raw(lat)


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    manifest = {"jax": jax.__version__, "cases": {}, "latent": dict(LATENT)}
    arrays = {}
    for name, seed, chain, shape, dtype in CASES:
        d = draw(seed, chain, shape, dtype)
        manifest["cases"][name] = {"seed": seed, "chain": chain, "shape": shape, "dtype": dtype,
                                   "key": d["key"], "bits_sha256": sha(d["bits"]),
                                   "uniform_sha256": sha(d["uniform"]), "normal_sha256": sha(d["normal"])}
        arrays[name] = d["normal"]
    lat = latent()
    manifest["latent"]["sha256"] = sha(lat)
    arrays["latent"] = lat
    np.savez(os.path.join(HERE, "normals.npz"), **arrays)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()

"""The port's bounded prompt-embedding cache against the JAX package's.

Both pipelines hold the same tiny T5 and CLIP weights (the JAX random init,
carried by `utils/jax_bridge.py`). A hit returns exactly what the miss
encoded, which is exactly the uncached encode of the same batch; at a cap of
3 the same call sequence leaves the same keys in the same order on both
sides, and a key the current call reads is never evicted.
"""

import dataclasses

import numpy as np
import pytest
import torch

from reflectionflow_tpu_torch.config import TTSConfig
from reflectionflow_tpu_torch.search.artifacts import load_image
from reflectionflow_tpu_torch.search.noise_scaling import run_noise_scaling
from reflectionflow_tpu_torch.utils.timing import PhaseTimer

from test_torch_pipeline import _pipelines

torch.set_num_threads(1)
L = 8
ATOL = 1e-4  # fp32 T5 / CLIP against JAX, as tests/test_torch_text_vae.py


@pytest.fixture(scope="module")
def bridged():
    return _pipelines()


@pytest.fixture
def pipes(bridged):
    """The bridged (JAX, port) pair with empty caches."""
    for pipe in bridged:
        pipe._embed_cache = None
        pipe._embed_cache_cap = 2048
    return bridged


def test_hits_are_exact_and_match_jax(pipes):
    jpipe, tpipe = pipes
    jpipe.enable_prompt_cache()
    tpipe.enable_prompt_cache()
    prompts = ["a cat", "b dog"]  # already sorted: the miss batch is this batch
    t_miss = tpipe.encode_prompts(prompts, L)
    plain = dataclasses.replace(tpipe, _embed_cache=None).encode_prompts(prompts, L)
    for got, want in zip(t_miss, plain):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    t_hit = tpipe.encode_prompts(["b dog", "a cat", "b dog"], L)
    for got, miss in zip(t_hit, t_miss):
        torch.testing.assert_close(got, miss[[1, 0, 1]], rtol=0, atol=0)
    # a tower split keys on the (clip, t5) pair, not on the CLIP prompt alone
    t_split = tpipe.encode_prompts(["a cat"], L, prompts_2=["b dog"])
    torch.testing.assert_close(t_split[0], t_miss[0][1:], rtol=0, atol=0)
    torch.testing.assert_close(t_split[1], t_miss[1][:1], rtol=0, atol=0)
    j_miss = jpipe.encode_prompts(prompts, L)
    j_hit = jpipe.encode_prompts(["b dog", "a cat", "b dog"], L)
    j_split = jpipe.encode_prompts(["a cat"], L, prompts_2=["b dog"])
    for got, want in zip((*t_miss, *t_hit, *t_split), (*j_miss, *j_hit, *j_split)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)
    assert list(tpipe._embed_cache) == list(jpipe._embed_cache)
    assert all(t.device.type == "cpu" for entry in tpipe._embed_cache.values() for t in entry)


def test_eviction_order_matches_jax_at_a_small_cap(pipes):
    jpipe, tpipe = pipes
    for pipe in (jpipe, tpipe):
        pipe.enable_prompt_cache()
        pipe._embed_cache_cap = 3
    calls = [
        (["p3", "p1"], L, None),
        (["p2"], L, None),
        (["p0", "p1"], L, None),      # 4 keys: p3, the oldest not read now, goes
        (["p1"], 16, None),           # same prompt at another length is another key
        (["a", "b", "c", "d"], L, None),  # reads 4 keys: the cache overflows its cap
        (["p1", "e"], L, None),
        (["x"], L, ["y"]),
    ]
    for prompts, length, prompts_2 in calls:
        jt, jp = jpipe.encode_prompts(prompts, length, prompts_2=prompts_2)
        tt, tp = tpipe.encode_prompts(prompts, length, prompts_2=prompts_2)
        needed = {((c, t), length) for c, t in zip(prompts, prompts_2 or prompts)}
        assert needed <= set(tpipe._embed_cache)  # never evicts what this call reads
        assert list(tpipe._embed_cache) == list(jpipe._embed_cache)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL, rtol=1e-4)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL, rtol=1e-4)
    assert len(tpipe._embed_cache) == 3
    jpipe.warm_prompt_cache(["w2", "w1", "w2", "e"], L, batch=1)
    tpipe.warm_prompt_cache(["w2", "w1", "w2", "e"], L, batch=1)
    assert list(tpipe._embed_cache) == list(jpipe._embed_cache)


def test_noise_scaling_warms_the_cache_and_keeps_its_images(pipes, tmp_path):
    tpipe = dataclasses.replace(pipes[1])
    cfg = TTSConfig()
    pa = cfg.pipeline_args
    pa.height = pa.width = 16
    pa.num_inference_steps, pa.max_sequence_length = 2, L
    cfg.search_args.search_rounds = 2
    rows = [{"prompt": "a red cube"}, {"prompt": "a dog"}]
    run_noise_scaling(tpipe, cfg, rows, str(tmp_path / "plain"), run_seed=1)
    encoded = []
    raw = tpipe._encode_raw
    tpipe.enable_prompt_cache()
    tpipe._encode_raw = lambda pairs, length: encoded.append(list(pairs)) or raw(pairs, length)
    timer = PhaseTimer()
    run_noise_scaling(tpipe, cfg, rows, str(tmp_path / "cached"), run_seed=1, timer=timer)
    assert encoded == [[("a dog", "a dog"), ("a red cube", "a red cube")]]  # one warm, no round encodes
    assert timer.summary()["encode"]["count"] == 1
    # the warm encodes another batch than the uncached rounds do: equal within
    # fp32 batch-composition noise, so within 1 level after the uint8 cast
    for sub in ("00000", "00001"):
        names = sorted(p.name for p in (tmp_path / "plain" / sub / "samples").iterdir())
        assert names and names == sorted(p.name for p in (tmp_path / "cached" / sub / "samples").iterdir())
        for name in names:
            a = load_image(str(tmp_path / "cached" / sub / "samples" / name)).astype(np.int16)
            b = load_image(str(tmp_path / "plain" / sub / "samples" / name)).astype(np.int16)
            assert np.abs(a - b).max() <= 1

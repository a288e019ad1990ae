"""The port's multi-process serving dryrun (the counterpart of the JAX
`tests/test_multihost.py`): two gloo ranks on the CPU, each its own process
and process-group member, run a cross-rank `all_reduce_sum` and the
noise-scaling block over a rank-contiguous shard of the prompts; the
artifact tree must equal a one-rank run's byte for byte
(`parallel.dryrun.dryrun_multihost`, file rendezvous under the test's
temporary directory)."""

from reflectionflow_tpu_torch.parallel.dryrun import ROWS, dryrun_multihost


def test_dryrun_multihost_artifacts_identical(tmp_path):
    out = dryrun_multihost(2, device="cpu", workdir=str(tmp_path))
    assert out["compare"]["identical"] and out["compare"]["png_max_diff"] == 0
    # 4 prompts x (2 rounds x 2 candidates + metadata.jsonl)
    assert out["compare"]["files"] == len(ROWS) * 5
    for rank, r in enumerate(out["ranks"]):
        assert (r["rank"], r["world"], r["backend"], r["sum"]) == (rank, 2, "gloo", 1.0)
        assert r["prompts"] == [2 * rank, 2 * rank + 2]
        assert r["counts"]["all_reduce_sum"] == 1 and r["counts"]["host_copies"] == 0

"""The PyTorch port imports no JAX, no JAX-package module and none of the
packages its target machine lacks: every port module (the K8/K9 ops, the
corrector sampler, the meshes (of ranks and of one process's devices), the
collectives, the TP specs, the mesh dryruns and ring attention, the verifiers, reflectors and
search loops, the BPE tokenizers, the snapshot loader, the Qwen2.5-VL models,
the reward-model trainer, the Qwen verifier and the host image codecs and
tar indexer included), and the
noise-scaling, train, sample, reflectionflow, noise-prompt-scaling,
verifier-filter, score-images, vcache-calibrate and train-reward CLIs' --help, run in a
subprocess where those imports fail."""

import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "reflectionflow_tpu", "pydantic", "PIL", "safetensors", "transformers", "regex",
           "cv2", "torchvision")

_SCRIPT = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import reflectionflow_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert not any(n.split(".")[0] in {BLOCKED!r} for n in sys.modules if sys.modules[n] is not None)
print(len(names), " ".join(names))
import contextlib, io
for cli in ("tts_t2i_noise_scaling", "train", "sample", "tts_reflectionflow",
            "tts_t2i_noise_prompt_scaling", "verifier_filter", "score_images", "vcache_calibrate",
            "train_reward"):
    main = importlib.import_module("reflectionflow_tpu_torch.cli." + cli).main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            main(["--help"])
        except SystemExit:
            pass
    print("=== " + cli)
    print(out.getvalue())
"""


def test_port_imports_without_jax_and_friends():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules, rest = proc.stdout.split("\n", 1)
    n_modules = n_modules.split(" ", 1)[0]
    expected = sum(1 for m in pkgutil.walk_packages(
        [os.path.join(REPO, "reflectionflow_tpu_torch")], "reflectionflow_tpu_torch."))
    assert int(n_modules) == expected >= 20
    noise_help, rest = rest.split("=== tts_t2i_noise_scaling\n")[1].split("=== train\n")
    train_help, rest = rest.split("=== sample\n")
    sample_help, rest = rest.split("=== tts_reflectionflow\n")
    rf_help, rest = rest.split("=== tts_t2i_noise_prompt_scaling\n")
    nps_help, rest = rest.split("=== verifier_filter\n")
    filter_help, rest = rest.split("=== score_images\n")
    score_help, rest = rest.split("=== vcache_calibrate\n")
    cal_help, reward_help = rest.split("=== train_reward\n")
    assert "--synthetic_weights" in noise_help and "--attn_impl" in noise_help
    assert "--device" in noise_help
    assert "--device" in train_help and "--synthetic_data" in train_help
    for flag in ("--image_guidance_scale", "--root_dir", "--device", "--synthetic_weights"):
        assert flag in sample_help
    for flag in ("--prompt_block", "--parallel_blocks", "--imgpath"):
        assert flag in rf_help
    for text in (rf_help, nps_help, filter_help):
        assert "--device" in text and "--synthetic_weights" in text
    assert "--nfes" in filter_help and "--images_subdir" in filter_help
    for flag in ("--meta_path", "--output_json", "--model_path", "--device"):
        assert flag in score_help
    for flag in ("--synthetic_weights", "--synthetic_scale", "--out", "--device", "--verifier"):
        assert flag in cal_help
    for flag in ("--meta_data", "--quantize_base", "--vision_lora", "--resume_from", "--fsdp_devices",
                 "--synthetic_weights", "--device"):
        assert flag in reward_help
    for name in ("cli.sample", "ops.flash_attention_int8", "ops.flash_attention_nr", "parallel.mesh",
                 "ops.ring_attention", "verifiers.openai_backend", "verifiers.schemas", "verifiers.prompts",
                 "reflect.generator", "reflect.refiner", "reflect.parsing", "search.reflectionflow",
                 "search.state", "search.noise_prompt_scaling", "search.nfe_filter",
                 "cli.tts_reflectionflow", "cli.tts_t2i_noise_prompt_scaling", "cli.verifier_filter",
                 "utils.bpe", "utils.hf_loader", "utils.device", "models.registry", "models.qwen_vl.lm",
                 "models.qwen_vl.vision", "models.qwen_vl.model", "models.qwen_vl.reward",
                 "models.qwen_vl.generate", "rm_train.train", "verifiers.qwen_verifier", "cli.score_images",
                 "cli.vcache_calibrate", "sampler.vcache_calibrate", "rm_train.losses", "rm_train.data",
                 "cli.train_reward", "utils.image_io", "utils.native", "parallel.collectives",
                 "parallel.distributed", "parallel.specs", "parallel.dryrun"):
        assert f"reflectionflow_tpu_torch.{name}" in proc.stdout

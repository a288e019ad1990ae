"""The port's verifiers, reflectors and refiners against the JAX package.

The fake backends must agree dict for dict and string for string on seeded
images and prompts; the grading schemas must give pydantic's JSON schema and
validation results; the OpenAI-compatible backend must send the JAX request
bodies to a local stub server (apart from the PNG bytes in the data URL,
which must decode to the same pixels) and keep its order, retry and failure
contract.
"""

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from reflectionflow_tpu.reflect import FakeReflector as JFakeReflector
from reflectionflow_tpu.reflect import FakeRefiner as JFakeRefiner
from reflectionflow_tpu.reflect import parsing as jparsing
from reflectionflow_tpu.utils.jsonl import recover_json_from_text as j_recover
from reflectionflow_tpu.verifiers import FakeNvilaVerifier as JFakeNvila
from reflectionflow_tpu.verifiers import FakeVerifier as JFakeVerifier
from reflectionflow_tpu.verifiers import base as jbase
from reflectionflow_tpu.verifiers import schemas as jschemas
from reflectionflow_tpu.verifiers.openai_backend import OpenAICompatVerifier as JOpenAI
from reflectionflow_tpu.verifiers.prompts import load_prompt as j_load_prompt
from reflectionflow_tpu_torch.reflect import FakeReflector, FakeRefiner, load_reflector, load_refiner
from reflectionflow_tpu_torch.reflect import parsing
from reflectionflow_tpu_torch.train.data import decode_png
from reflectionflow_tpu_torch.utils.jsonl import recover_json_from_text
from reflectionflow_tpu_torch.verifiers import FakeNvilaVerifier, FakeVerifier, load_verifier
from reflectionflow_tpu_torch.verifiers import base, schemas
from reflectionflow_tpu_torch.verifiers.openai_backend import OpenAICompatVerifier
from reflectionflow_tpu_torch.verifiers.prompts import load_prompt

torch.set_num_threads(1)
TAGS = (None, "single_object", "two_object", "counting", "colors", "position", "color_attr",
        "not_a_geneval_tag")
PROMPT_FILES = ("verifier_prompt.txt", "geneval_verifier_prompt.txt",
                "geneval_detailed_verifier_prompt.json", "refine_prompt.txt", "reflexion_prompt.txt")


def _images(n, seed=0, size=(6, 5)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*size, 3), dtype=np.uint8) for _ in range(n)]


PROMPTS = ["a photo of a red cube", "two dogs", "", "ünïcode prompt ✓", "a bench and a clock"]


@pytest.mark.parametrize("tag", TAGS)
def test_fake_verifiers_match_jax(tag):
    imgs = _images(len(PROMPTS), seed=1)
    assert FakeVerifier().score(imgs, PROMPTS, tag=tag) == JFakeVerifier().score(imgs, PROMPTS, tag=tag)
    quality = lambda img, p: float(img.mean()) / 25.5  # noqa: E731
    assert (FakeVerifier(quality_fn=quality).score(imgs, PROMPTS, tag=tag)
            == JFakeVerifier(quality_fn=quality).score(imgs, PROMPTS, tag=tag))
    for thr in (0.5, 0.2):
        assert (FakeNvilaVerifier(yes_threshold=thr).score(imgs, PROMPTS, tag=tag)
                == JFakeNvila(yes_threshold=thr).score(imgs, PROMPTS, tag=tag))
    assert FakeNvilaVerifier.output_kind == JFakeNvila.output_kind == "yes_no"
    assert FakeVerifier.output_kind == JFakeVerifier.output_kind == "score"


def test_ranking_rules_and_topk_match_jax():
    rng = np.random.default_rng(2)
    imgs = _images(7, seed=3)
    scored = FakeVerifier().score(imgs, ["p"] * 7)
    yes_no = FakeNvilaVerifier().score(imgs, ["p"] * 7)
    # ties as well: equal scores must keep the same (stable) order
    ties = [{"overall_score": {"score": float(s)}} for s in rng.integers(0, 3, 9)]
    plain = [{"overall_score": float(s)} for s in rng.integers(0, 5, 6)]
    for kind, outs in (("score", scored), ("yes_no", yes_no), ("score", ties), ("score", plain)):
        rule, jrule = base.RankingRule(kind=kind), jbase.RankingRule(kind=kind)
        assert [rule.key(o) for o in outs] == [jrule.key(o) for o in outs]
        for k in (1, 2, len(outs), 2 * len(outs) + 1):
            assert base.select_topk(outs, k, rule) == jbase.select_topk(outs, k, jrule)
    for mod in (base, jbase):
        with pytest.raises(ValueError, match="empty"):
            mod.select_topk([], 1, mod.RankingRule())


@pytest.mark.parametrize("tag", TAGS)
def test_schemas_match_pydantic(tag):
    ours, theirs = schemas.schema_for_tag(tag), jschemas.schema_for_tag(tag)
    assert ours.__name__ == theirs.__name__
    # the OpenAI request embeds the dict: same keys in the same order
    assert json.dumps(ours.model_json_schema()) == json.dumps(theirs.model_json_schema())
    assert schemas.axes_for_tag(tag) == jschemas.axes_for_tag(tag)
    axes = schemas.axes_for_tag(tag)
    cases = [{a: {"score": 7, "explanation": "e"} for a in axes}]
    for bad_score in (7.0, "8", " 9 ", "7.0", True, 7.5, None, "1e1", [1]):
        cases.append({a: {"score": bad_score, "explanation": "x", "extra": 1} for a in axes})
    cases += [{a: {"score": 1, "explanation": 3} for a in axes},
              {a: {"score": 1} for a in axes}, dict(list(cases[0].items())[1:]), [1, 2], "text"]
    for data in cases:
        try:
            want = theirs.model_validate(data).model_dump()
        except Exception:  # noqa: BLE001 — pydantic's ValidationError
            with pytest.raises(ValueError):
                ours.model_validate(data)
        else:
            assert ours.model_validate(data).model_dump() == want


def test_prompt_assets_and_json_recovery_match_jax():
    for name in PROMPT_FILES:
        assert load_prompt(name) == j_load_prompt(name)
    texts = ['{"a": 1}', 'prefix {"a": {"b": [1, 2]}} suffix', '```json\n{"x": 2}\n```', "[1, 2] tail",
             'reply: ```\n{"y": "z"}\n``` done', "no json here", "{broken"]
    for text in texts:
        try:
            want = j_recover(text)
        except ValueError:
            with pytest.raises(ValueError, match="no JSON"):
                recover_json_from_text(text)
        else:
            assert recover_json_from_text(text) == want


REFLECTIONS = [
    "1. Missing objects:\n- a second dog\n- a leash\n\n2. Colors:\n- None\n\n3. Layout:\n- move the cube left",
    "Nothing structured here.",
    "Style: make it brighter\n\n.:\n- x\n\n4. Count:\n- None needed",
    "",
    "1. A: b\n- c\n\n\n2. D:\n- e:f",
]


def test_reflection_parsing_matches_jax():
    for text in REFLECTIONS:
        assert parsing.parse_reflection_sections(text) == jparsing.parse_reflection_sections(text)
        assert parsing.flatten_reflection(text) == jparsing.flatten_reflection(text)
    assert parsing.flatten_reflections(REFLECTIONS) == jparsing.flatten_reflections(REFLECTIONS)


def test_fake_reflector_and_refiner_match_jax():
    imgs = _images(4, seed=5)
    orig = ["a cat", "a cat", "two dogs", "x"]
    cur = ["a cat, highly detailed", "something else", "two dogs", "x, highly detailed"]
    assert (FakeReflector().generate(imgs, orig, cur, ["r"] * 4, ["e"] * 4)
            == JFakeReflector().generate(imgs, orig, cur, ["r"] * 4, ["e"] * 4))
    assert FakeRefiner().refine(imgs, orig, cur) == JFakeRefiner().refine(imgs, orig, cur)
    assert isinstance(load_reflector("fake"), FakeReflector)
    assert isinstance(load_refiner("fake"), FakeRefiner)


def test_model_backends_raise_naming_their_item(tmp_path, monkeypatch):
    """The model backends raise for what they lack: `nvila` a local snapshot
    (it never downloads), `nvila_jax` and the Qwen verifiers a model path, the
    local reflector a generator."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="never downloads"):
        load_verifier("nvila", device="cpu")
    for name in ("nvila_jax", "qwen_rm", "image_verifier"):
        with pytest.raises(ValueError, match="model_path"):
            load_verifier(name)
    with pytest.raises(TypeError, match="model"):
        load_reflector("local_qwen")
    with pytest.raises(ValueError, match="unknown"):
        load_verifier("nope")


# ---------------------------------------------------------------------------
# OpenAI-compatible backend against a local stub server
# ---------------------------------------------------------------------------


class StubHandler(BaseHTTPRequestHandler):
    fail_first = 0  # fail this many requests with 500 before succeeding
    lock = threading.Lock()
    request_count = 0
    bodies: list = []

    def log_message(self, *args):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        with StubHandler.lock:
            StubHandler.request_count += 1
            n = StubHandler.request_count
            StubHandler.bodies.append((self.path, self.headers["Authorization"], body))
        if n <= StubHandler.fail_first:
            self.send_response(500)
            self.end_headers()
            return
        user_texts = [c["text"] for m in body["messages"] if isinstance(m.get("content"), list)
                      for c in m["content"] if c.get("type") == "text"]
        tag_text = " ".join(user_texts)
        score = sum(ord(c) for c in tag_text) % 10
        if "response_format" in body:
            fields = body["response_format"]["json_schema"]["schema"]["properties"].keys()
            content = "Here you go: " + json.dumps({f: {"score": score, "explanation": f"stub:{f}"}
                                                    for f in fields})
        else:
            content = f"REPLY[{tag_text[:40]}]"
        data = json.dumps({"choices": [{"message": {"content": content}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture()
def server():
    StubHandler.fail_first = 0
    StubHandler.request_count = 0
    StubHandler.bodies = []
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), StubHandler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}/v1"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _decoded(body, decode):
    """The body with each data URL replaced by its decoded pixels (as a list)."""
    out = json.loads(json.dumps(body))
    for m in out["messages"]:
        if isinstance(m.get("content"), list):
            for c in m["content"]:
                if c.get("type") == "image_url":
                    head, payload = c["image_url"]["url"].split(",", 1)
                    data = base64.b64decode(payload, validate=True)
                    assert head == "data:image/png;base64" and base64.b64encode(data).decode() == payload
                    c["image_url"]["url"] = decode(data).tolist()
    return out


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _run_both(server, call):
    """The same call through both backends; their requests in order of the
    first user text (threads send them in any order)."""
    got = {}
    for name, cls in (("jax", JOpenAI), ("torch", OpenAICompatVerifier)):
        StubHandler.bodies = []
        v = cls(base_url=server, api_key="stub", max_retries=3, retry_delay_s=0.01, max_workers=3)
        result = call(v)
        decode = _pil_decode if name == "jax" else decode_png
        bodies = sorted(((p, a, _decoded(b, decode)) for p, a, b in StubHandler.bodies),
                        key=lambda t: json.dumps(t[2]["messages"][1]["content"][0]))
        got[name] = (result, bodies)
    return got


@pytest.mark.parametrize("tag", [None, "counting", "colors"])
def test_openai_score_requests_and_results_match_jax(server, tag):
    imgs = _images(3, seed=7, size=(5, 4))
    prompts = ["aaa", "bbbb", "cc"]
    got = _run_both(server, lambda v: v.score(imgs, prompts, tag=tag, max_new_tokens=64))
    assert got["torch"] == got["jax"]
    outs, bodies = got["torch"]
    assert [o["overall_score"]["score"] for o in outs] == [sum(map(ord, p)) % 10 for p in prompts]
    assert list(outs[0]) == schemas.axes_for_tag(tag)
    path, auth, body = bodies[0]
    assert path == "/v1/chat/completions" and auth == "Bearer stub"
    assert body["max_tokens"] == 64 and body["seed"] == 1994
    assert body["messages"][1]["content"][1]["image_url"]["url"] == imgs[0].tolist()


def test_openai_refine_and_reflect_requests_match_jax(server):
    imgs = _images(2, seed=8, size=(4, 4))
    for call in (
        lambda v: v.refine_prompt(imgs, ["o1", "o2"], ["c1", "c2"], reflections=["r1", ""],
                                  evaluations=["e1", "e2"]),
        lambda v: v.generate_reflections(imgs, ["o1", "o2"], ["c1", "c2"]),
        lambda v: v.generate_reflections(imgs, ["o1", "o2"], ["c1", "c2"], prev_reflections=["p", "q"],
                                         evaluations=["e", ""], max_new_tokens=9),
    ):
        got = _run_both(server, call)
        assert got["torch"] == got["jax"]
        assert all(r.startswith("REPLY[") for r in got["torch"][0])


def test_openai_retry_and_failure_sentinel(server):
    StubHandler.fail_first = 2
    v = OpenAICompatVerifier(base_url=server, api_key="stub", max_retries=3, retry_delay_s=0.01)
    outs = v.score(_images(1), ["p"])
    assert outs[0]["overall_score"]["score"] == sum(map(ord, "p")) % 10
    assert StubHandler.request_count == 3

    StubHandler.fail_first = 10**9  # always fail: every entry keeps its place
    outs = v.score(_images(2), ["a", "b"], tag="position")
    assert len(outs) == 2
    assert all(list(o) == schemas.axes_for_tag("position") for o in outs)
    assert all(o[a]["score"] == float("-inf") for o in outs for a in o)
    assert v.refine_prompt(_images(2), ["o", "o"], ["c1", "c2"]) == ["c1", "c2"]
    assert v.generate_reflections(_images(2), ["o", "o"], ["c1", "c2"]) == ["", ""]

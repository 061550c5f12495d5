"""CPU tests of the generation cell (``qwen2.5-14b.batch2k``) and of the
harness's driver interface.

The cell runs whole through ``harness.run_once`` at the port's reduced
qwen2.5-14b (``configs.reduced``: 2 layers of width 64, GQA 4/2, a
vocabulary of 256) on 8 prompts of 32 tokens and 8 output tokens, and
comes out correct against the plain reference (``model_reference.py``) on
the sound program, and not correct with the 4-bit control or with each
fault of ``model_faults.py`` planted underneath. The counts behind the
per-layer metrics are held to the readings PERF.md records.
"""
from __future__ import annotations

import copy
import pathlib
import re
import subprocess
import sys
import time
import types

import pytest

torch = pytest.importorskip("torch")

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from benchlib import generate, harness, model_faults, model_reference  # noqa: E402,E501
from benchlib import manifest as mf  # noqa: E402
from benchlib import model_weights, program  # noqa: E402
from benchlib.record import Run  # noqa: E402
from benchlib.roofline import bound_s, load_count  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402

CELL = "qwen2.5-14b.batch2k"
MANIFEST = mf.load()
SEED = 2**31 + 7
# On the CPU the program computes in float32, not bfloat16, so the cell's
# limits (set from bfloat16 runs on the card) are not this size's. These
# follow the same rule from this size's readings (4 seeds): the sound
# program 3.3e-7 to 5.4e-7 and token gaps of 0, the 4-bit control 0.040
# to 0.060 and 0.0032 to 0.011.
TINY_LIMITS = {"logits_rel": 1e-3, "token_gap": 1e-3, "malformed_calls": 0}


def tiny() -> tuple[dict, dict]:
    """The cell's configuration at the port's reduced sizes, with the
    float32 setting's limits, and its traffic at 8 x 32 prompt tokens and
    8 output tokens."""
    _, cfg, tr = mf.cell(MANIFEST, CELL)
    r = reduced(get_config(cfg["arch"]))
    cfg = dict(copy.deepcopy(cfg), num_hidden_layers=r.num_layers,
               hidden_size=r.d_model, num_attention_heads=r.n_heads,
               num_key_value_heads=r.n_kv_heads, intermediate_size=r.d_ff,
               vocab_size=r.vocab_size, limits=TINY_LIMITS)
    return cfg, dict(tr, batch=8, prompt_len=32, gen=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny model's ops on one thread: under the test runner's parallel
    workers, torch's default threads oversubscribe the host's cores and a
    call's eight decode steps took seconds."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_tiny(seed: int = SEED, control: bool = False):
    cfg, tr = tiny()
    return harness.run_once(MANIFEST, CELL, seed, 2.0, device="cpu",
                            t_proc=time.monotonic(), config=cfg, traffic=tr,
                            control=control)


def test_generation_cell_is_correct_on_cpu():
    run, metrics, correct, checks, _ = run_tiny()
    assert correct, checks
    assert run.attempted >= 1 and run.failed == 0
    assert checks["logits_rel"]["value"] < 1e-5
    for m in mf.metrics_for(MANIFEST, CELL, False):
        assert metrics[m["name"]]["value"] > 0, m["name"]


def test_generation_control_is_not_correct():
    _, _, correct, checks, _ = run_tiny(control=True)
    assert not correct, checks


def test_kernel_route_stand_in_alone_is_correct():
    with model_faults.kernel_route_stand_in():
        _, _, correct, checks, _ = run_tiny()
    assert correct, checks


@pytest.mark.parametrize("fault", sorted(model_faults.FAULTS))
def test_generation_planted_fault_is_not_correct(fault):
    with model_faults.kernel_route_stand_in(), model_faults.FAULTS[fault]():
        _, _, correct, checks, _ = run_tiny()
    assert not correct, checks


def test_control_at_test_size_reads_far_over_the_sound_program():
    """The float32 setting's two readings, on two more seeds: the sound
    program under a hundredth of its limit, the control over ten times."""
    for seed in (11, 12):
        _, _, _, sound, _ = run_tiny(seed=seed)
        _, _, _, low, _ = run_tiny(seed=seed, control=True)
        assert sound["logits_rel"]["value"] < TINY_LIMITS["logits_rel"] / 100
        assert low["logits_rel"]["value"] > 10 * TINY_LIMITS["logits_rel"]


def test_reference_agrees_with_program_within_1e_4():
    """The port's whole forward and its served path against the plain
    reference, on the same drawn weights, in float32 on the CPU."""
    from repro_torch.launch.steps import make_positions
    from repro_torch.models import transformer as tf

    cfg, _ = tiny()
    server = program.model_server(cfg, SEED, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (3, 40),
                           generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        hidden, _ = tf.forward(server.params, server.cfg, tokens,
                               make_positions(3, 40))
        got = tf.logits_fn(server.params, server.cfg, hidden)
    want = model_reference.logits(cfg, SEED, tokens, 0)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4
    out = torch.as_tensor(server.generate(tokens[:, :32].numpy(), 8))
    ref = model_reference.logits(cfg, SEED, torch.cat(
        [tokens[:, :32], out.long()], 1), 31)
    assert torch.equal(out.long(), ref[:, :-1].argmax(-1))


def test_weights_are_drawn_from_seed_and_name():
    cfg, _ = tiny()
    a = model_weights.layer(cfg, SEED, 1, "cpu")
    b = model_weights.layer(cfg, SEED, 1, "cpu")
    c = model_weights.layer(cfg, SEED + 1, 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mixer.wq"], c["mixer.wq"])
    assert not torch.equal(a["mixer.wq"][:, :16], a["mixer.wk"][:, :16])
    assert torch.equal(a["ffn.w1"], a["ffn.w1"].bfloat16().float())
    for k in ("mixer.bq", "mixer.bk", "mixer.bv", "norm1.scale"):
        assert a[k].dtype == torch.float32 and float(a[k].abs().min()) > 0
    names = [n for n, _, _ in model_weights.specs(cfg)]
    assert len(names) == len(set(names)) == 3 + 2 * 12


def test_checked_rows_take_one_from_each_share():
    for seed in (0, 2**31 + 3, 2**33 + 1):
        rows = generate.checked_rows(seed, 16, 4)
        assert [r // 4 for r in rows] == [0, 1, 2, 3]
    assert generate.checked_rows(9, 16, 4) == generate.checked_rows(9, 16, 4)
    p = generate.prompts(2**31 + 1, 3, 16, 2048, 152064)
    assert p.shape == (16, 2048) and p.dtype.name == "int32"
    assert p.max() < 152064 and (p == generate.prompts(2**31 + 1, 3, 16,
                                                       2048, 152064)).all()


def test_run_once_needs_only_run_cell_and_numbers(monkeypatch):
    """A driver is a module with ``run_cell`` and ``numbers``: run_once
    names no driver."""
    seen = {}

    def run_cell(run, device, t_proc, trace_window=None):
        run.t_open, run.t_close, run.setup_s = 1.0, 2.0, 0.5
        run.attempted = 3
        return {"answer": 7}

    def numbers(run, state, config, control):
        seen["args"] = (state, config["k"], control)
        return {"answers_wrong": int(state["answer"] != 7) + int(control)}

    monkeypatch.setitem(sys.modules, "benchlib.fake_driver", types.SimpleNamespace(
        run_cell=run_cell, numbers=numbers))
    manifest = {"configs": [{"name": "kron20",
                             "file": "bench/configs/kron20.json"}],
                "workloads": [{"name": "fake", "config": "kron20",
                               "traffic": "timeline", "chips": 1}],
                "end_to_end": [{"name": "setup_s", "unit": "s"}],
                "per_layer": []}
    for control in (False, True):
        run, metrics, correct, checks, _ = harness.run_once(
            manifest, "fake", 5, 1.0, device="cpu", t_proc=0.0,
            config={"k": "v", "limits": {"answers_wrong": 0}},
            traffic={"driver": "fake_driver"}, control=control)
        assert correct is not control and run.attempted == 3
        assert checks["answers_wrong"]["limit"] == 0
        assert metrics == {"setup_s": {"value": 0.5, "unit": "s"}}
        assert seen["args"] == ({"answer": 7}, "v", control)
    source = (BENCH / "benchlib" / "harness.py").read_text()
    assert not re.search(r"""["'](serve|timeline|generate)["']""", source)


def test_flash_attention_count_matches_perf_table():
    count = load_count("flash_attention")
    shape = {"b": 4, "hq": 40, "hkv": 8, "s": 4096, "hd": 128,
             "dtype": "bfloat16"}
    got = f"{bound_s(count, shape) * 1e3:.4f}"
    assert got == "0.6950"
    assert re.search(r"B = 4, Hq = 40, Hkv = 8, S = 4096, hd = 128 bf16 "
                     r"\(qwen2.5-14b.*\| 0\.6950 \(operations\)",
                     (ROOT / "PERF.md").read_text())


def test_decode_step_count_matches_the_recorded_bound():
    _, cfg, _ = mf.cell(MANIFEST, CELL)
    count = load_count("decode_step")
    # phase 14d's qwen2.5-14b: 4 requests, 4096 prompt, 32 steps
    assert f"{count.bound_s(cfg, 4, 4096, 32) * 1e3:.3f}" == "9.319"
    assert "9.319 ms" in (ROOT / "PERF.md").read_text()
    # the port's own parameter count: bf16 matrices but the embedding,
    # float32 norm scales and biases
    mcfg = get_config("qwen2.5-14b")
    small = mcfg.num_layers * (2 * mcfg.d_model + mcfg.q_dim
                               + 2 * mcfg.kv_dim) + mcfg.d_model
    matrices = mcfg.param_count() - mcfg.vocab_size * mcfg.d_model - small
    assert count.weight_bytes(cfg) == 2 * matrices + 4 * small


def test_generate_flops_count_the_port_parameters():
    _, cfg, _ = mf.cell(MANIFEST, CELL)
    count = load_count("qwen2_forward")
    mcfg = get_config("qwen2.5-14b")
    layer = mcfg._block_params("attn") - 2 * mcfg.d_model - mcfg.q_dim \
        - 2 * mcfg.kv_dim
    B, P, gen = 16, 2048, 128
    attn = 4 * B * mcfg.n_heads * mcfg.resolved_head_dim * mcfg.num_layers
    head = 2 * B * mcfg.d_model * mcfg.vocab_size
    assert count.prefill_flops(cfg, B, P) == \
        2 * B * P * mcfg.num_layers * layer + attn * P * (P + 1) // 2 + head
    assert count.decode_flops(cfg, B, P, gen) == gen * (
        2 * B * mcfg.num_layers * layer + head) + attn * sum(
            P + t + 1 for t in range(gen))


def _synthetic_run() -> Run:
    """Three calls of the full-size cell finished in a 45 s window, the
    second under the profiler: 2 s prefills, decode loops of 9 s and 8 s
    (the traced call's 20 s, which the host-clock readers leave out), 48
    ``flash_attention`` launches at 1.8 ms each."""
    _, cfg, tr = mf.cell(MANIFEST, CELL)
    run = Run(CELL, cfg, tr, 1, 45.0)
    run.t_open, run.t_close = 100.0, 145.0
    for i, s in enumerate((100.0, 111.5, 123.0, 134.5)):
        a = {"call": i + 1, "batch": 16, "prompt": 2048, "gen": 128,
             "tokens": 2048, "prefill_s": 2.0,
             "decode_s": (9.0, 20.0, 8.0, 9.0)[i], "traced": i == 1}
        run.spans.append(("generate", s, s + 11.2, a))
        run.kernel_calls.append((s, s + 2.0, "flash_attention", 48,
                                 {"b": 16, "hq": 40, "hkv": 8, "s": 2048,
                                  "hd": 128, "dtype": "bfloat16"}))
    run.trace = {"t0": 111.4, "t1": 116.0, "busy_s": 2.3, "window_s": 4.6,
                 "kernels": {"void flash_attention_wgmma_kernel<128>(...)":
                             [48, 48 * 1.8e-3], "other": [10, 0.5]}}
    return run


def test_model_readers_on_a_synthetic_run():
    run = _synthetic_run()
    # gen_tok_s is staged: its reader is there, its manifest entry is not
    names = [m["name"] for m in mf.metrics_for(MANIFEST, CELL, True)
             + mf.metrics_for(MANIFEST, CELL, False)] + ["gen_tok_s"]
    got = {name: mf.reader(name)(run) for name in names}
    assert got["gen_tok_s"] == pytest.approx(3 * 2048 / 34.2)
    assert got["ttft_ms"] == pytest.approx(2000.0)
    assert got["decode_step_ms.batch2k"] == pytest.approx(8500 / 128)
    assert got["device_idle.batch2k"] == pytest.approx(50.0)
    assert got["flash_attention_roofline.batch2k"] == pytest.approx(
        100 * 0.6951772615571284 / 1.8)
    assert got["decode_roofline.batch2k"] == pytest.approx(
        100 * 10.337302619701493 * 128 / 1000 * (1 / 9 + 1 / 8) / 2)
    assert got["prefill_mfu.batch2k"] == pytest.approx(
        100 * 898.891776e12 / 2.0 / 989e12)
    assert got["generate_mfu.batch2k"] == pytest.approx(
        100 * 960.45040140288e12 / 11.2 / 989e12)
    for name, value in got.items():
        if name.endswith(("_roofline.batch2k", "_mfu.batch2k")):
            assert 0 < value <= 100, name
    run.trace = None
    assert mf.reader("flash_attention_roofline.batch2k")(run) is None
    run.spans = []
    assert all(mf.reader(n)(run) is None for n in
               ("gen_tok_s", "ttft_ms", "decode_step_ms.batch2k"))


def test_model_reference_loads_no_program_and_no_jax():
    code = (
        "import sys; sys.path[:0] = ['bench', 'src']\n"
        "import benchlib.model_reference, benchlib.model_weights\n"
        "import benchlib.calls\n"
        "from benchlib.roofline import load_count\n"
        "for k in ('qwen2_forward', 'decode_step', 'flash_attention'):\n"
        "    load_count(k)\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "bad = mods & {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}\n"
        "assert not bad, bad\n"
        "import benchlib.generate, benchlib.model_faults\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "assert not mods & {'jax', 'jaxlib', 'flax', 'repro'}, mods\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

"""CPU tests of the DeepSeek-V2 generation cell (``deepseek-v2-lite.doc16k``,
driver ``generate_mla``).

The cell runs whole through ``harness.run_once`` at a reduced
``deepseek-v2-lite`` (3 layers, hidden 64, 4 heads, latent 32, nope /
rope / v 16 / 8 / 16, 8 experts top-2 with 2 shared, a vocabulary of 256)
on 8 prompts of 32 tokens and 8 output tokens, and comes out correct
against the plain reference (``deepseek_v2_reference.py``) on the sound
program, and not correct with the 4-bit control or with each fault of
``mla_moe_faults.py`` planted underneath. The counts behind the
per-layer metrics are held to hand-worked numbers at the cell's shape.
"""
from __future__ import annotations

import copy
import pathlib
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from benchlib import harness, mla_moe_faults  # noqa: E402
from benchlib import manifest as mf  # noqa: E402
from benchlib.record import Run  # noqa: E402
from benchlib.roofline import bound_s, load_count  # noqa: E402

CELL = "deepseek-v2-lite.doc16k"
MANIFEST = mf.load()
SEED = 2**31 + 7
# On the CPU the program computes in float32, not bfloat16, so the cell's
# limits (set from bfloat16 runs on the card) are not this size's. These
# follow the same rule from this size's readings (3 seeds): the sound
# program's logits and latents 3.9e-7 to 4.5e-7, token gaps and route
# flips 0; the 4-bit control's 0.058 to 0.068, token gaps 0.0032 to
# 0.0087, flips 2.2 to 2.5 % of the choices by up to 0.0019 to 0.0029.
TINY_LIMITS = {"logits_rel": 1e-3, "token_gap": 1e-3, "malformed_calls": 0,
               "route_flip_share": 5e-3, "route_flip_gap": 5e-4,
               "latent_cache_rel": 1e-3}


def tiny() -> tuple[dict, dict]:
    _, cfg, tr = mf.cell(MANIFEST, CELL)
    cfg = dict(copy.deepcopy(cfg), num_hidden_layers=3, hidden_size=64,
               num_attention_heads=4, num_key_value_heads=4,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
               intermediate_size=128, moe_intermediate_size=64,
               vocab_size=256, limits=TINY_LIMITS)
    return cfg, dict(tr, batch=8, prompt_len=32, gen=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_tiny(seed: int = SEED, control: bool = False):
    cfg, tr = tiny()
    return harness.run_once(MANIFEST, CELL, seed, 0.5, device="cpu",
                            t_proc=time.monotonic(), config=cfg, traffic=tr,
                            control=control)


def test_cell_resolves_from_the_manifest():
    cell, cfg, tr = mf.cell(MANIFEST, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "deepseek-v2-lite", "doc16k", 1)
    assert tr["driver"] == "generate_mla" and tr["prompt_len"] == 16384
    assert tr["gen"] == 128 and tr["batch"] % 8 == 0
    conf = next(c for c in MANIFEST["configs"]
                if c["name"] == "deepseek-v2-lite")
    assert conf["reduced"] == [] and cfg["source"] == conf["source"]
    e2e = {m["name"] for m in mf.metrics_for(MANIFEST, CELL, False)}
    assert e2e == {"gen_tok_s", "ttft_ms", "setup_s"}
    layer = {m["name"] for m in mf.metrics_for(MANIFEST, CELL, True)}
    assert len(layer) == 9 and all(n.endswith(".doc16k") for n in layer)


def test_mla_cell_is_correct_on_cpu():
    run, metrics, correct, checks, _ = run_tiny()
    assert correct, checks
    assert run.attempted >= 1 and run.failed == 0
    assert checks["logits_rel"]["value"] < 1e-5
    assert checks["route_flip_share"]["value"] == 0.0
    for m in mf.metrics_for(MANIFEST, CELL, False):
        assert metrics[m["name"]]["value"] > 0, m["name"]


@pytest.mark.parametrize("fault", ["control"] + sorted(mla_moe_faults.FAULTS))
def test_mla_control_and_planted_faults_are_not_correct(fault):
    if fault == "control":
        _, _, correct, checks, _ = run_tiny(control=True)
    else:
        with mla_moe_faults.FAULTS[fault]():
            _, _, correct, checks, _ = run_tiny()
    assert not correct, checks


def test_forward_count_by_hand():
    """Model operations at the cell's shape (16 x 16,384 + 128), worked
    by hand from the published sizes."""
    _, cfg, _ = mf.cell(MANIFEST, CELL)
    count = load_count("deepseek_v2_forward")
    attn = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    assert attn == 13_762_560
    dense = 3 * 2048 * 10944
    moe = 2048 * 64 + (6 + 2) * 3 * 2048 * 1408
    per_token = 2 * (27 * attn + dense + 26 * moe)
    assert per_token == 4_483_186_688
    pair = 2 * (128 + 64 + 128) * 16 * 27
    head = 2 * 2048 * 102400
    B, P, gen = 16, 16384, 128
    prefill = B * P * per_token + B * P * (P + 1) // 2 * pair + B * head
    assert count.prefill_flops(cfg, B, P) == prefill
    assert f"{prefill:.4e}" == "1.7690e+15"
    keys = gen * P + gen * (gen + 1) // 2
    assert count.decode_flops(cfg, B, P, gen) == \
        gen * B * (per_token + head) + B * keys * pair


def test_kernel_counts_by_hand():
    """One prefill attention launch over 4 sequences of 16,384 (the
    program's group), and one grouped expert product over a group's
    32,768 x 6 slots touching all 64 experts, at 989 TFLOP/s and 3.35
    TB/s."""
    mla = load_count("mla_prefill")
    shape = {"b": 4, "h": 16, "s": 16384, "dqk": 192, "dv": 128,
             "dtype": "bfloat16"}
    assert mla.flops(**shape) == 2 * 320 * 4 * 16 * 134_225_920
    assert mla.bytes_moved(**shape) == 2 * 4 * 16 * 16384 * 640
    assert f"{bound_s(mla, shape) * 1e3:.4f}" == "5.5590"
    experts = load_count("moe_experts")
    shape = {"slots": 196_608, "d": 2048, "f": 1408, "experts": 64,
             "dtype": "bfloat16"}
    assert experts.flops(**shape) == 2 * 196_608 * 2048 * 1408
    assert experts.bytes_moved(**shape) == 2 * (64 * 2048 * 1408
                                                + 196_608 * 3456)
    assert f"{bound_s(experts, shape) * 1e3:.4f}" == "1.1465"


def test_decode_byte_count_by_hand():
    """A decode step's bytes at the cell's shape (24 x 16,384 + 128, 58
    experts touched a MoE layer), worked by hand from the published
    sizes: 2,210,904,064 outside the routed experts, 17,301,504 an expert
    and layer, and the latent cache's 576 bf16 numbers a position, layer
    and sequence at 16,384 + 64.5 positions on average."""
    _, cfg, _ = mf.cell(MANIFEST, CELL)
    count = load_count("mla_decode_step")
    attn = 2 * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048) \
        + 4 * (2048 + 512 + 2048)
    dense = 2 * 3 * 2048 * 10944
    moe = 4 * 2048 * 64 + 2 * 3 * 2048 * 2816
    rest = 27 * attn + dense + 26 * moe + 2 * 2048 * 102400 + 4 * 2048
    assert rest == 2_210_904_064
    assert count.weight_bytes(cfg, 0) == rest
    expert = 2 * 3 * 2048 * 1408
    assert count.weight_bytes(cfg, 58) == rest + 26 * 58 * expert
    cache = 24 * 27 * 576 * 2 * (16384 + 64.5)
    assert count.cache_bytes(cfg, 24, 16384, 128) == cache == 12_278_739_456
    total = rest + 26 * 58 * expert + cache
    assert total == 40_580_311_552
    assert f"{count.bound_s(cfg, 24, 16384, 128, 58) * 1e3:.4f}" == "12.1135"


def test_traced_call_counts_the_experts_decode_steps_touch():
    """In the traced call the route hook marks, for every decode step and
    MoE layer, the experts its tokens choose; the run keeps their mean
    count, which lies between top-k and the experts, and the decode's
    share of its byte bound reads it."""
    import types

    from benchlib import generate_mla

    class Window:
        t0 = t1 = None
        prof = types.SimpleNamespace(events=lambda: [])

        def start(self):
            self.t0 = time.monotonic()

        def stop(self):
            self.t1 = time.monotonic()

    cfg, tr = tiny()
    tr = dict(tr, trace_offset_s=0.0, trace_decode_steps=2)
    run = Run(CELL, cfg, tr, SEED, 0.5)
    generate_mla.run_cell(run, torch.device("cpu"), time.monotonic(),
                          Window())
    touched = run.counters["moe_decode_touched"]
    assert 2 <= touched <= 8
    calls = [a for _, _, _, a in run.window_spans("generate")
             if not a["traced"]]
    value = mf.reader("decode_roofline.doc16k")(run)
    assert value is None if not calls else value > 0
    run.counters = {}
    assert mf.reader("decode_roofline.doc16k")(run) is None


def test_readers_on_a_synthetic_run():
    """The nine per-layer readers on a synthetic traced run: a call of 4
    s prefill and 2.56 s of decode (20 ms a step), the traced one; 48
    flash launches at 16 ms; 3 x 26 grouped products of 1.5 ms; the
    prefill's loads; two decode-step MoE spans of 300 us."""
    import types

    _, cfg, tr = mf.cell(MANIFEST, CELL)
    run = Run(CELL, cfg, tr, 1, 45.0)
    run.t_open, run.t_close = 100.0, 145.0
    B = tr["batch"]
    for i, s in enumerate((100.0, 107.0)):
        run.spans.append(("generate", s, s + 6.6, {
            "call": i + 1, "batch": B, "prompt": 16384, "gen": 128,
            "tokens": B * 128, "prefill_s": 4.0, "decode_s": 2.56,
            "traced": i == 1}))
    run.kernel_calls += [
        (107.0, 111.0, "mla_prefill", 48, {"b": 4, "h": 16, "s": 16384,
                                           "dqk": 192, "dv": 128,
                                           "dtype": "bfloat16"}),
        (107.0, 111.0, "moe_experts", 78, {"slots": 196_608, "d": 2048,
                                           "f": 1408, "experts": 64.0,
                                           "dtype": "bfloat16"})]
    run.trace = {"t0": 106.9, "t1": 112.0, "busy_s": 4.08, "window_s": 5.1,
                 "kernels": {"flash_attention_wgmma_kernel<256>": [48, 0.768],
                             "cutlass::GroupProblemShape<...>": [78, 0.117],
                             "prepare_grouped_gemm_data": [78, 0.01],
                             "other": [10, 0.5]}}
    run.counters["moe_prefill_load"] = [[10] * 63 + [370], [20] * 64]
    run.counters["moe_decode_touched"] = 58.0
    spans = [types.SimpleNamespace(name="Model.moe", start=0.0, end=3e-4,
                                   attrs={"tokens": B, "slots": 6 * B})] * 2
    got = {}
    import benchlib.program_spans as ps
    real = ps.named
    try:
        ps.named = lambda r, name: spans
        for m in mf.metrics_for(MANIFEST, CELL, True):
            got[m["name"]] = mf.reader(m["name"])(run)
    finally:
        ps.named = real
    assert got["decode_step_ms.doc16k"] == pytest.approx(20.0)
    assert got["decode_roofline.doc16k"] == pytest.approx(
        100 * load_count("mla_decode_step").bound_s(cfg, B, 16384, 128, 58)
        / 20e-3)
    assert got["device_idle.doc16k"] == pytest.approx(20.0)
    assert got["mla_prefill_roofline.doc16k"] == pytest.approx(
        100 * 5.55901e-3 / 16e-3, rel=1e-4)
    assert got["moe_experts_roofline.doc16k"] == pytest.approx(
        100 * 1.14646e-3 / 1.5e-3, rel=1e-4)
    assert got["moe_load_max.doc16k"] == pytest.approx(370 * 64 / 1000)
    assert got["moe_issue_us.doc16k"] == pytest.approx(300.0)
    assert got["prefill_mfu.doc16k"] == pytest.approx(
        100 * load_count("deepseek_v2_forward").prefill_flops(
            cfg, B, 16384) / 4.0 / 989e12)
    for name, value in got.items():
        if name.endswith(("_roofline.doc16k", "_mfu.doc16k")):
            assert 0 < value <= 100, name
    run.trace, run.counters = None, {}
    assert mf.reader("moe_load_max.doc16k")(run) is None
    assert mf.reader("mla_prefill_roofline.doc16k")(run) is None


def test_reference_loads_no_program_and_no_jax():
    code = (
        "import sys; sys.path[:0] = ['bench', 'src']\n"
        "import benchlib.deepseek_v2_reference, benchlib.deepseek_v2_weights\n"
        "from benchlib.roofline import load_count\n"
        "for k in ('deepseek_v2_forward', 'mla_prefill', 'moe_experts',\n"
        "          'mla_decode_step'):\n"
        "    load_count(k)\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "bad = mods & {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}\n"
        "assert not bad, bad\n"
        "import benchlib.generate_mla, benchlib.mla_moe_faults\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "assert not mods & {'jax', 'jaxlib', 'flax', 'repro'}, mods\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

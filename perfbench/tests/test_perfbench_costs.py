"""The yardstick's counts against sums worked out by hand, and each
per-layer reader on a record whose answer is known."""
import pytest

from perfbench.harness import bench, costs

GROK = bench.load_cell("grok-1-314b.serve").config
QWEN = bench.load_cell("qwen3-14b.train").config


def test_grok_parameters_by_hand():
    # a layer: q, o 2·6144·6144 = 75,497,472; k, v 2·6144·1024 = 12,582,912;
    # two norms 12,288; router 6144·8 = 49,152; an expert 3·6144·32768 =
    # 603,979,776 (two active: 1,207,959,552; all eight: 4,831,838,208)
    active_layer = 75_497_472 + 12_582_912 + 12_288 + 49_152 + 1_207_959_552
    all_layer = 75_497_472 + 12_582_912 + 12_288 + 49_152 + 4_831_838_208
    head = 6144 * 131072                                    # 805,306,368
    assert costs.params_no_embed(GROK, True) == 4 * active_layer + 6144 + head \
        == 5_989_718_016
    assert costs.params_no_embed(GROK, False) == 4 * all_layer + 6144 + head \
        == 20_485_232_640


def test_qwen3_parameters_and_train_flops_by_hand():
    # a layer: q, o 2·5120·5120 = 52,428,800; k, v 2·5120·1024 = 10,485,760;
    # norms 10,240; q/k norms 256; MLP 3·5120·17408 = 267,386,880
    layer = 52_428_800 + 10_485_760 + 10_240 + 256 + 267_386_880
    n = 4 * layer + 5120 + 5120 * 151936
    assert costs.params_no_embed(QWEN) == n == 2_099_165_184
    # 6·N·T over 8 × 2048, and attention: 12·H·Dh·L a causal pair,
    # 8 rows × 2048·2049/2 pairs
    attn = 12 * 40 * 128 * 4 * 8 * (2048 * 2049 // 2)
    assert attn == 4_125_181_870_080
    assert costs.train_step_flops(QWEN, 8, 2048) == 6 * n * 16384 + attn \
        == 210_481_516_118_016
    attn_long = 12 * 40 * 128 * 4 * 2 * (8192 * 8193 // 2)
    assert costs.train_step_flops(QWEN, 2, 8192) == 6 * n * 16384 + attn_long


def test_decode_tick_bound_by_hand():
    weights = 2 * 20_485_232_640 + 2 * 64 * 6144            # all experts + 64 rows
    assert costs.decode_weight_bytes(GROK, 2, 64) == weights == 40_971_251_712
    kv_row = 2 * 8 * 128 * 2 * 4                            # K and V, 4 layers
    assert costs.kv_row_bytes(GROK, 2) == kv_row == 16_384
    flops = 2 * 5_989_718_016 * 64 + 4 * 48 * 128 * 4 * 6400
    t = costs.decode_tick_bound_s(GROK, 2, 64, 64, 6400)
    assert t == pytest.approx(max((weights + 6400 * kv_row) / 3.35e12, flops / 989e12))
    assert t == pytest.approx(41_076_109_312 / 3.35e12)    # bound by the bytes


def test_kernel_costs_by_hand():
    e = costs.expert_bmm_cost(GROK, 2, 64)
    per = 8 * (64 * 6144 + 6144 * 32768 + 64 * 32768)      # one bmm's operands
    assert e["bytes"] == 3 * per * 2 == 9_783_214_080
    assert e["flops"] == 6 * 8 * 64 * 6144 * 32768 == 618_475_290_624
    d = costs.decode_attention_cost(GROK, 2, 64, 6400)
    assert d["flops"] == 4 * 48 * 128 * 6400
    assert d["bytes"] == (2 * 6400 * 8 * 128 + 2 * 64 * 48 * 128) * 2 + 4 * 6400 + 4 * 64
    f = costs.flash_fwd_cost(QWEN, 2, 2, 2048)
    q, k = 2 * 2048 * 40 * 128, 2 * 2048 * 8 * 128
    assert f["flops"] == 4 * 128 * 40 * 2 * (2048 * 2049 // 2) == 85_941_288_960
    assert f["bytes"] == (2 * q + 2 * k) * 2 + 4 * 2 * 2 * 2048 + 4 * 2 * 2048 * 40
    b = costs.flash_bwd_cost(QWEN, 2, 2, 2048)
    assert b["flops"] == 2.5 * f["flops"]
    assert b["bytes"] == (4 * q + 4 * k) * 2 + 4 * 2 * 2048 * 40 + 4 * 2 * 2 * 2048


def _serve_rec(**kw):
    rec = {"mode": "serve", "config": GROK, "traffic": {"max_batch": 64}, "elem": 2,
           "window_s": 0.25, "ticks": 10, "live": [64] * 10, "kv": [6400] * 10,
           "answered": 5, "gateway_s": 0.02, "guard_launches": 80,
           "peak_bytes": 45_800_000_000, "trace": None}
    rec.update(kw)
    return rec


def read(name, rec):
    return bench.metric_reader(name).read(rec)


def test_serve_readers():
    rec = _serve_rec()
    assert read("tick_ms.serve", rec) == pytest.approx(25.0)
    assert read("slot_fill.serve", rec) == pytest.approx(100.0)
    assert read("slot_fill.serve", _serve_rec(live=[32] * 10)) == pytest.approx(50.0)
    assert read("gateway_ms.serve", rec) == pytest.approx(4.0)
    assert read("guard_launches_per_request.serve", rec) == pytest.approx(16.0)
    flops = 10 * (2 * 5_989_718_016 * 64 + 4 * 48 * 128 * 4 * 6400)
    assert read("mfu.serve", rec) == pytest.approx(100 * flops / 0.25 / 989e12)
    assert read("step_roofline.serve", rec) == pytest.approx(
        100 * 10 * (41_076_109_312 / 3.35e12) / 0.25)
    assert read("peak_mem_gb.serve", rec) == pytest.approx(45.8)
    # nothing traced: the trace's readers find nothing and say so
    for name in ("expert_ffn_roofline", "decode_attention_roofline", "idle_share.serve"):
        assert read(name, rec) is None
    # the training readers find nothing in a serving record
    assert read("mfu.train", rec) is None


def test_serve_trace_readers():
    ops = {"ticks": 16, "host_op_device_s": {"aten::bmm": 16 * 4 * 0.0031}}
    tr = {"busy_s": 0.9, "wall_s": 1.5, "ticks": 64, "kv": [6400] * 64,
          "families": {"decode_attention": 64 * 4 * 2e-5}, "ops": ops}
    rec = _serve_rec(trace=tr)
    assert read("idle_share.serve", rec) == pytest.approx(40.0)
    bmm = costs.bound_s(9_783_214_080, 618_475_290_624)     # bytes bound: 2.92 ms
    assert read("expert_ffn_roofline", rec) == pytest.approx(100 * bmm / 0.0031)
    d = costs.decode_attention_cost(GROK, 2, 64, 6400)
    assert read("decode_attention_roofline", rec) == pytest.approx(
        100 * costs.bound_s(d["bytes"], d["flops"]) / 2e-5)
    rec["trace"]["ops"]["host_op_device_s"] = {}
    assert read("expert_ffn_roofline", rec) is None


def test_train_readers():
    mix = {"global_batch": 8, "seq_len": 2048, "micro": 2}
    tr = {"busy_s": 1.3, "wall_s": 1.35, "launches": {"flash_attention": 32,
                                                       "flash_attention_bwd": 32},
          "families": {"gemm": 0.6, "elementwise": 0.4, "copy_cat_memcpy": 0.1,
                       "flash_attention": 0.02, "flash_attention_bwd": 0.03,
                       "reduce": 0.15}}
    rec = {"mode": "train", "config": QWEN, "traffic": mix, "elem": 2,
           "window_s": 30.0, "steps": 45, "peak_bytes": 63.2e9, "trace": tr}
    assert read("mfu.train", rec) == pytest.approx(
        100 * 210_481_516_118_016 * 45 / 30.0 / 989e12)
    assert read("elementwise_share.train", rec) == pytest.approx(100 * 0.5 / 1.3)
    assert read("idle_share.train", rec) == pytest.approx(100 * (1 - 1.3 / 1.35))
    f = costs.flash_fwd_cost(QWEN, 2, 2, 2048)
    b = costs.flash_bwd_cost(QWEN, 2, 2, 2048)
    want = 32 * costs.bound_s(f["bytes"], f["flops"]) + 32 * costs.bound_s(b["bytes"], b["flops"])
    assert read("flash_attention_roofline", rec) == pytest.approx(100 * want / 0.05)
    assert read("peak_mem_gb.train", rec) == pytest.approx(63.2)
    rec["trace"] = None
    assert read("flash_attention_roofline", rec) is None
    assert read("tick_ms.serve", rec) is None

"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; without a card every test skips (the decision is taken in
the ``cuda_device`` fixture, never at import, so every pytest worker
collects the same tests). On a machine with one:

    python -m pytest -m cuda tests/test_torch_cuda.py

The kernels build from ``src/repro_torch/csrc`` into ``build/`` at first use.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import repro_torch.configs as tconfigs
from repro_torch.core import charge, controller, fleet, perfmodel
from repro_torch.kernels.charge_sweep import kernel as sweep_kernel
from repro_torch.kernels.charge_sweep import ops as sweep_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.latency_matmul import kernel as mm_kernel
from repro_torch.kernels.latency_matmul import ops as mm_ops
from repro_torch.kernels.replay_step import kernel as replay_kernel
from repro_torch.kernels.replay_step import ops as replay_ops
from repro_torch.kernels.rglru_scan import kernel as sc_kernel
from repro_torch.kernels.rglru_scan import ops as sc_ops
from repro_torch.launch import altune_margin
from repro_torch.launch import serve as lm_launch
from repro_torch.launch import serve_fleet, trace_eval
from repro_torch.launch import train as lm_train

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _sweep_stack(case, dev):
    """Charge-sweep invariants of a seed-0 fleet of 50,001 DIMMs (so no cell
    count is a multiple of a warp: the last warp is partial). "fleet": at
    45/55/85/95 °C. "mixed lanes": one cell a DIMM, neighbouring lanes ending
    their searches at very different candidates — 45 and 95 °C alternating
    lane by lane, JEDEC-corner cells, worst-case cells (no search passes) and
    masks at 0."""
    n = 50_001
    g = torch.Generator(device=dev).manual_seed(0)
    fl = fleet.synthesize(g, n, device=dev)
    if case == "fleet":
        cells = charge.CellParams(*(a[None, :] for a in fl.cells))
        temps = torch.tensor([45.0, 55.0, 85.0, 95.0], device=dev)[:, None]
        return sweep_ops.stacked_invariants(cells, temps)[0]
    lane = torch.arange(n, device=dev)
    inv, _ = sweep_ops.stacked_invariants(fl.cells, torch.where(lane % 2 == 0, 45.0, 95.0))
    c = charge.DEFAULT_CONSTANTS
    corner = charge.CellParams(*(torch.full((3,), v, device=dev)
                                 for v in (c.r_max, c.c_min, 1.0)))
    inv_corner, _ = sweep_ops.stacked_invariants(
        corner, torch.tensor([45.0, 85.0, 95.0], device=dev))
    lanes = lane[7::97]
    inv[:, lanes] = inv_corner[:, lanes % 3]
    return chip_smoke.sweep_masks_off(chip_smoke.sweep_worst_case(inv, slice(3, None, 11)))


@pytest.mark.parametrize("case", ["fleet", "mixed lanes"])
def test_charge_sweep_kernel_matches_plain(cuda_device, case):
    inv = _sweep_stack(case, cuda_device)
    scal = sweep_ops.kernel_scalars()
    before = sweep_kernel.charge_sweep_cuda.launches
    got = sweep_kernel.charge_sweep_cuda(inv, scal)
    assert sweep_kernel.charge_sweep_cuda.launches == before + 1
    want = sweep_kernel.charge_sweep_plain(inv, scal)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [4099, 4112])   # the narrow and the 16-byte copy path
@pytest.mark.parametrize("chunk", [1, 37, 160, 256])
def test_replay_kernel_matches_plain(cuda_device, chunk, n):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    table = serve_fleet.bootstrap_table(g, n, device=cuda_device)
    n = table.n_dimms
    p = controller.ControllerParams()
    ladder = []
    for e in table.temp_bins:
        gb = e - p.guard_band_c
        ladder += [e, gb, gb - p.hysteresis_c,
                   float(np.nextafter(np.float32(gb), np.float32(-np.inf)))]
    ladder = torch.tensor(sorted(ladder, reverse=True) * 3, device=cuda_device)
    temps = torch.cat([ladder[:, None].expand(-1, n),
                       torch.rand((260, n), generator=g, device=cuda_device) * 75 + 20])
    errs = (torch.rand(temps.shape, generator=g, device=cuda_device) < 1e-3).to(torch.uint8)
    scal = replay_ops.replay_scalars(table.temp_bins, p)
    stack_t = replay_ops.to_stack_t(table.stack)
    x = y = (replay_ops.to_state3(controller.init_state(n, table.n_bins, cuda_device)),
             torch.zeros((table.n_bins + 1, n), dtype=torch.int32, device=cuda_device),
             torch.zeros(n, dtype=torch.int32, device=cuda_device),
             torch.zeros((8, n), device=cuda_device))
    for s in range(0, temps.shape[0], chunk):
        # Row slices of the step-major trace: views at any byte offset.
        tc, ec = temps[s:s + chunk].contiguous(), errs[s:s + chunk].contiguous()
        x = replay_kernel.replay_chunk_cuda(*x, stack_t, tc, ec, scal)
        y = replay_kernel.replay_chunk_plain(*y, stack_t, tc, ec, scal)
    torch.cuda.synchronize()
    for a, b in zip(x, y):
        assert torch.equal(_bits(a), _bits(b))


def _emit_outputs(chunk, n, dev, aligned):
    """Decision outputs; rows 4 bytes past a 16-byte boundary unless ``aligned``."""
    out = replay_kernel.Decisions.empty(chunk, n, dev)
    if aligned:
        return out
    flat = torch.empty(chunk * n * 8 + 1, device=dev)
    rows = flat[1:].view(chunk, n, 2, 4)
    assert rows.data_ptr() % 16 == 4
    return out._replace(rows=rows)


@pytest.mark.parametrize("n", [4099, 4112])   # narrow copies / 16-byte copies
@pytest.mark.parametrize("chunk", [1, 37, 160, 256])
def test_replay_emit_kernel_matches_plain(cuda_device, chunk, n):
    """The emitting entry against the plain emit scan, bitwise: each chunk's
    rows (at 4,099 DIMMs into a view 4 bytes off a 16-byte boundary), bins,
    switch and fuse flags, and the carried state and partials, which also
    equal the non-emitting entry's."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    table = serve_fleet.bootstrap_table(g, n, device=cuda_device)
    temps = torch.rand((300, n), generator=g, device=cuda_device) * 75 + 20
    errs = (torch.rand(temps.shape, generator=g, device=cuda_device) < 2e-3).to(torch.uint8)
    scal = replay_ops.replay_scalars(table.temp_bins, controller.ControllerParams())
    stack_t = replay_ops.to_stack_t(table.stack)
    x = y = z = (replay_ops.to_state3(controller.init_state(n, table.n_bins, cuda_device)),
                 torch.zeros((table.n_bins + 1, n), dtype=torch.int32, device=cuda_device),
                 torch.zeros(n, dtype=torch.int32, device=cuda_device),
                 torch.zeros((8, n), device=cuda_device))
    before = replay_kernel.replay_chunk_cuda.launches
    for s in range(0, temps.shape[0], chunk):
        tc, ec = temps[s:s + chunk].contiguous(), errs[s:s + chunk].contiguous()
        out = _emit_outputs(tc.shape[0], n, cuda_device, aligned=n % 16 == 0)
        *x, got = replay_kernel.replay_chunk_emit_cuda(*x, stack_t, tc, ec, scal, out)
        assert got is out
        *y, want = replay_kernel.replay_chunk_emit_plain(*y, stack_t, tc, ec, scal)
        z = replay_kernel.replay_chunk_cuda(*z, stack_t, tc, ec, scal)
        torch.cuda.synchronize()
        for name, a, b in zip(got._fields, got, want):
            assert torch.equal(_bits(a), _bits(b)), name
        assert set(got.switched.view(torch.uint8).unique().tolist()) <= {0, 1}
    assert replay_kernel.replay_chunk_cuda.launches == before + 2 * -(-300 // chunk)
    for a, b, c in zip(x, y, z):
        assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a), _bits(c))


def test_ingest_decisions_on_card_matches_cpu(cuda_device):
    """``ingest(return_decisions=True)`` on the card against the CPU, ragged
    chunks with errors arriving mid-stream and non-emitting chunks between:
    decisions, state and partials bitwise; the switch total stays on the card."""
    from repro_torch.core import stream

    g = torch.Generator(device=cuda_device).manual_seed(7)
    table = serve_fleet.bootstrap_table(g, 3001, device=cuda_device)
    trace = (torch.rand((300, 3001), generator=g, device=cuda_device) * 75 + 20).cpu()
    errors = (torch.rand((300, 3001), generator=g, device=cuda_device) < 2e-3).cpu()
    card = stream.StreamingController(table)
    host = stream.StreamingController(table.to("cpu"))
    for k, (s, e) in enumerate(((0, 7), (7, 100), (100, 101), (101, 230), (230, 300))):
        err = errors[s:e] if k >= 2 else None
        emit = k != 3
        got = card.ingest(trace[s:e], err, return_decisions=emit)
        want = host.ingest(trace[s:e], err, return_decisions=emit)
        assert card.total_switches.device.type == "cuda"
        for a, b in zip(got or (), want or ()):
            assert a.device.type == "cuda" and torch.equal(_bits(a.cpu()), _bits(b))
    for a, b in zip(card.partials, host.partials):
        assert torch.equal(_bits(a.cpu()), _bits(b))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card.state, host.state))
    assert int(card.total_switches) == int(host.total_switches) > 0


@pytest.mark.parametrize("chunk_steps", [None, 16])
def test_replay_launches_per_chunk_and_equals_cpu(cuda_device, chunk_steps, monkeypatch):
    """``controller.replay`` on the card: one launch of the emitting entry a
    ``REPLAY_CHUNK_STEPS`` steps (here also at 16, ragged over 100 steps),
    its history and final state equal to the CPU's."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    table, temps, errs = _card_replay(g, cuda_device, 4099, 100, error_rate=5e-3)
    monkeypatch.setattr(replay_ops, "REPLAY_CHUNK_STEPS", chunk_steps)
    before = replay_kernel.replay_chunk_cuda.launches
    res = controller.replay(table, temps, errs)
    launches = replay_kernel.replay_chunk_cuda.launches - before
    assert launches == (1 if chunk_steps is None else -(-100 // chunk_steps))
    host = controller.replay(table.to("cpu"), temps.cpu(), errs.cpu())
    for k in ("timings", "bin_idx", "switched", "fused"):
        assert torch.equal(_bits(getattr(res, k).cpu()), _bits(getattr(host, k))), k
    assert all(torch.equal(a.cpu(), b) for a, b in zip(res.state, host.state))


def test_service_on_card_matches_cpu(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    table = serve_fleet.bootstrap_table(g, 1000, device=cuda_device)
    trace = (torch.rand((300, 1000), generator=g, device=cuda_device) * 60 + 20).cpu()
    errors = (torch.rand((300, 1000), generator=g, device=cuda_device) < 1e-3).cpu()
    on_card = serve_fleet.FleetControllerService(table)
    on_cpu = serve_fleet.FleetControllerService(
        controller.DimmTimingTable(table.temp_bins, table.stack.cpu()))
    before = replay_kernel.replay_chunk_cuda.launches
    for s in range(0, 300, 64):
        on_card.submit(trace[s:s + 64], errors[s:s + 64])
        on_cpu.submit(trace[s:s + 64], errors[s:s + 64])
    assert replay_kernel.replay_chunk_cuda.launches == before + 5
    for a, b in zip(on_card.engine.partials, on_cpu.engine.partials):
        assert torch.equal(_bits(a.cpu()), _bits(b))
    want = on_cpu.running_score()
    for k, v in on_card.running_score().items():
        assert v == pytest.approx(want[k], abs=1e-5), k


def test_service_with_errors_arriving_midstream(cuda_device):
    """Staging buffers reserved up front; error buffers appear only with the
    first chunk that carries errors; a ragged last chunk; partials bitwise
    equal to the CPU service."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    table = serve_fleet.bootstrap_table(g, 1000, device=cuda_device)
    trace = (torch.rand((200, 1000), generator=g, device=cuda_device) * 60 + 20).cpu()
    errors = (torch.rand((200, 1000), generator=g, device=cuda_device) < 1e-2).cpu()
    on_card = serve_fleet.FleetControllerService(table, chunk_steps=64)
    on_cpu = serve_fleet.FleetControllerService(
        controller.DimmTimingTable(table.temp_bins, table.stack.cpu()))
    slots = on_card.engine._ingest._slots
    assert all(sl is not None and sl.rows == 64 for sl in slots)
    for s, with_errors in ((0, False), (64, False), (128, True), (192, True)):
        e = errors[s:s + 64] if with_errors else None
        on_card.submit(trace[s:s + 64], e)
        on_cpu.submit(trace[s:s + 64], e)
        if not with_errors:
            assert all(sl.errs is None for sl in slots)
    assert on_card.engine.errors_total == on_cpu.engine.errors_total > 0
    for a, b in zip(on_card.engine.partials, on_cpu.engine.partials):
        assert torch.equal(_bits(a.cpu()), _bits(b))


def _card_replay(g, dev, n, steps, error_rate=1e-3):
    """A card replay of temperatures over every bin, with errors."""
    table = serve_fleet.bootstrap_table(g, n, device=dev)
    temps = torch.rand((steps, n), generator=g, device=dev) * 75 + 20
    errs = torch.rand(temps.shape, generator=g, device=dev) < error_rate
    return table, temps, errs


def test_accumulate_kernel_matches_plain(cuda_device):
    """A ragged real history folded into nonzero running partials: every
    word equal; the JEDEC column is reached; one launch."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    table, temps, errs = _card_replay(g, cuda_device, 4099, 97)
    res = controller.replay(table, temps, errs)
    n, b1 = table.n_dimms, table.n_bins + 1
    start = (torch.randint(0, 50, (n, b1), generator=g, device=cuda_device, dtype=torch.int32),
             torch.randint(0, 50, (n,), generator=g, device=cuda_device, dtype=torch.int32),
             torch.randint(0, 400, (n, 2, 4), generator=g, device=cuda_device,
                           dtype=torch.int32).to(torch.float32) * 1.25)
    args = (*start, res.timings, res.bin_idx, res.switched.view(torch.uint8))
    before = replay_kernel.accumulate_cuda.launches
    got = replay_kernel.accumulate_cuda(*args)
    assert replay_kernel.accumulate_cuda.launches == before + 1
    want = replay_kernel.accumulate_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    assert int((got[0] - start[0])[:, -1].sum()) > 0      # fused or too hot: JEDEC
    # The perfmodel entry point dispatches to the kernel on the card.
    p = perfmodel.trace_score_accumulate(perfmodel.trace_score_init(n, table.n_bins, cuda_device),
                                         res.timings, res.bin_idx, res.switched)
    assert replay_kernel.accumulate_cuda.launches == before + 2
    assert int(p.n_steps) == 97


def test_card_step_matches_plain_step(cuda_device):
    """``replay`` on the card (the emitting entry, one launch a
    ``REPLAY_CHUNK_STEPS`` steps) and ``step`` on the card (the emitting
    entry at chunk 1, every step) are bitwise the plain step loop on the
    card."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    table, temps, errs = _card_replay(g, cuda_device, 4099, 64, error_rate=5e-3)
    before = replay_kernel.replay_chunk_cuda.launches
    res = controller.replay(table, temps, errs)
    c = replay_ops.REPLAY_CHUNK_STEPS or 64
    assert replay_kernel.replay_chunk_cuda.launches == before + -(-64 // c)
    edges = torch.tensor(table.temp_bins, dtype=torch.float32, device=cuda_device)
    st = controller.init_state(table.n_dimms, table.n_bins, cuda_device)
    p = controller.ControllerParams()
    for k in range(64):
        st, rows, sw, eff = controller.step_plain(table.stack, edges, p, st, temps[k], errs[k])
        assert torch.equal(_bits(res.timings[k]), _bits(rows))
        assert torch.equal(res.bin_idx[k], eff) and torch.equal(res.switched[k], sw)
        assert torch.equal(res.fused[k], st.fused)
    for a, b in zip(res.state, st):
        assert torch.equal(a, b)
    st = controller.init_state(table.n_dimms, table.n_bins, cuda_device)
    before = replay_kernel.replay_chunk_cuda.launches
    for k in range(64):
        st, rows, sw, eff = controller.step(table.stack, edges, p, st, temps[k], errs[k])
        assert torch.equal(_bits(rows), _bits(res.timings[k]))
        assert torch.equal(eff, res.bin_idx[k]) and torch.equal(sw, res.switched[k])
        assert torch.equal(st.fused, res.fused[k])
    assert replay_kernel.replay_chunk_cuda.launches == before + 64
    for a, b in zip(res.state, st):
        assert torch.equal(a, b)


def test_trace_eval_card_matches_cpu(cuda_device):
    kw = dict(scenario="refresh_storm", error_rate=1e-3, verbose=False,
              baseline_dimms=8, baseline_steps=64)
    card = trace_eval.run(n_dimms=512, n_steps=200, device=cuda_device, **kw)
    host = trace_eval.run(device="cpu", table=card["table"].to("cpu"),
                          trace=card["trace"].cpu(), errors=card["errors"].cpu(), **kw)
    for k in ("timings", "bin_idx", "switched", "fused"):
        assert torch.equal(_bits(getattr(card["replay"], k).cpu()),
                           _bits(getattr(host["replay"], k))), k
    for a, b in zip(card["partials"], host["partials"]):
        assert torch.equal(_bits(a.cpu()), _bits(b))
    assert set(card["score"]) == set(host["score"])
    for k, v in host["score"].items():
        assert card["score"][k] == pytest.approx(v, abs=1e-5), k


#: (b, sq, skv, h, hk, dh, causal, window): causal, windowed, ragged (no
#: multiple of the 64-row tile) and non-causal, GQA groups 1 to 16, every
#: head width the kernel is built for.
FA_CASES = {
    "causal-g3-dh128": (2, 200, 200, 24, 8, 128, True, 0),
    "window-g2-dh64": (1, 300, 300, 8, 4, 64, True, 100),
    "noncausal-ragged-g3-dh64": (2, 130, 77, 9, 3, 64, False, 0),
    "causal-g1-dh32": (2, 97, 97, 4, 4, 32, True, 0),
    "window-g2-dh320": (1, 300, 300, 8, 4, 320, True, 100),
    "window-mqa-dh256": (1, 333, 333, 16, 1, 256, True, 128),
    "noncausal-ragged-dh80": (2, 150, 150, 16, 16, 80, False, 0),
    "causal-ragged-g8-dh112": (2, 203, 203, 64, 8, 112, True, 0),
    "noncausal-ragged-g8-dh112": (1, 150, 77, 16, 2, 112, False, 0),
    "window-ragged-g4-dh16": (2, 301, 301, 8, 2, 16, True, 70),
}


@pytest.mark.parametrize("case", list(FA_CASES))
def test_flash_attention_kernel_matches_plain(cuda_device, case):
    b, sq, skv, h, hk, dh, causal, window = FA_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((b, sq, h, dh), generator=g, device=cuda_device)
    k, v = (torch.randn((b, skv, hk, dh), generator=g, device=cuda_device) for _ in range(2))
    want = fa_kernel.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert fa_ops.worst_case(dh) == fa_ops.candidates(dh)[0]
    for cfg in fa_ops.candidates(dh):
        before = fa_kernel.flash_attention_cuda.launches
        got = fa_ops.flash_attention(q, k, v, causal=causal, window=window, config=cfg)
        assert fa_kernel.flash_attention_cuda.launches == before + 1
        torch.cuda.synchronize()
        assert got.shape == want.shape == (b, sq, h, dh)
        assert float((got - want).abs().max()) <= fa_kernel.tolerance(want), cfg


def test_flash_attention_kernel_reads_strided_views(cuda_device):
    """q, k, v as slices of one fused projection, read in place, on every tile."""
    b, s, h, hk, dh = 2, 150, 8, 2, 64
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn((b, s, h + 2 * hk, dh), generator=g, device=cuda_device)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hk], qkv[:, :, h + hk:]
    want = fa_kernel.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                           causal=True)
    for tile in fa_kernel.TILES:
        got = fa_kernel.flash_attention_cuda(q, k, v, causal=True, tile=tile)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= fa_kernel.tolerance(want), tile


def test_lm_serve_on_card_matches_cpu(cuda_device):
    """Reduced Llama-3.2-3B with the same weights and prompts on the card
    (the flash-attention kernel, once per layer in the prefill) and on the
    CPU (plain versions). Last-position logits and caches within 1e-4
    (float32 sums in another order, transcendentals an ulp apart between the
    CPU and CUDA builds); greedy ids equal wherever the CPU's top-2 gap
    exceeds twice that. The decode is teacher-forced with the CPU's ids."""
    tol = 1e-4
    r = lm_launch.compare_card_to_cpu("llama3.2-3b", cuda_device, batch=2, prompt_len=40,
                                      steps=8, tol=tol)
    assert r["logit_err"] <= tol and r["cache_err"] <= tol
    assert r["sure"] > 0 and r["agree"] == r["sure"]
    assert r["prefill_launches"] == r["n_layers"] and r["decode_launches"] == 0


@pytest.mark.parametrize("arch", ["gemma3-4b", "chatglm3-6b", "qwen2-vl-72b", "hubert-xlarge",
                                  "recurrentgemma-9b", "xlstm-125m", "deepseek-moe-16b",
                                  "kimi-k2-1t-a32b"])
def test_lm_family_on_card_matches_cpu(cuda_device, arch):
    """Each reduced LM family card vs CPU as above: qwen2-vl fed embeddings
    and three M-RoPE position streams, hubert-xlarge one forward of
    embeddings (encoder-only), the MoE configs' routes compared too (a
    token routed to other experts on the card must be a near-tie on the
    CPU; later rows are left out); one kernel launch per attention layer
    (the reduced Kimi's at dh 16)."""
    tol = 1e-4
    r = lm_launch.compare_card_to_cpu(arch, cuda_device, batch=2, prompt_len=40, steps=8,
                                      tol=tol)
    assert r["logit_err"] <= tol and r["cache_err"] <= tol
    assert (r["sure"] > 0 or r["excluded_rows"] > 0) and r["agree"] == r["sure"]
    assert r["flips_not_near_tie"] == 0
    assert (r["moe_calls"] > 0) == (tconfigs.reduced(arch).moe is not None)
    assert r["prefill_launches"] == r["attn_layers"] and r["decode_launches"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_latency_matmul_kernel_matches_plain_on_every_tile(cuda_device, dtype):
    """Ragged shapes: rows that are not 16-byte aligned (517 and 129 columns;
    700 bfloat16 are 1,400 bytes) take the register path, 16-byte aligned
    views (rows of 520 with 517 used, float32) the cp.async path with partial
    chunks at the k and n edges."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    for m, k, n, ld in ((300, 517, 129, None), (1, 1, 1, None), (64, 16, 64, None),
                        (100, 300, 700, None), (257, 517, 300, 520)):
        x = torch.randn((m, ld or k), generator=g, device=cuda_device).to(dtype)[:, :k]
        y = torch.randn((k, n), generator=g, device=cuda_device).to(dtype)
        want = mm_kernel.matmul_plain(x, y)
        for cfg in mm_ops.CANDIDATES:
            before = mm_kernel.matmul_cuda.launches
            got = mm_ops.matmul(x, y, cfg)
            assert mm_kernel.matmul_cuda.launches == before + 1
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (m, n)
            assert float((got.float() - want.float()).abs().max()) <= mm_kernel.tolerance(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_kernel_bitwise_equals_plain_on_every_tile(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    words = torch.int32 if dtype == torch.float32 else torch.int16
    for b, s, d in ((2, 301, 129), (1, 5, 3)):
        a = (torch.rand((b, s, d), generator=g, device=cuda_device) * 0.9 + 0.05).to(dtype)
        bb = torch.randn((b, s, d), generator=g, device=cuda_device).to(dtype)
        h0 = torch.randn((b, d), generator=g, device=cuda_device).to(dtype)
        want = sc_kernel.rglru_scan_plain(a, bb, h0)
        for cfg in sc_ops.CANDIDATES:
            got = sc_ops.rglru_scan(a, bb, h0, cfg)
            torch.cuda.synchronize()
            assert torch.equal(got.view(words), want.view(words))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,dh", [(1, 64), (3, 128), (8, 128)])
def test_flash_decode_kernel_matches_plain_on_every_tile(cuda_device, dtype, group, dh):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    b, n, hk = 2, 1100, 2
    q = torch.randn((b, hk * group, dh), generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn((b, n, hk, dh), generator=g, device=cuda_device).to(dtype)
            for _ in range(2))
    # Lengths at the edges of a warp step (4 rows), of a block's round of
    # steps (16), of the ring (4 steps a warp) and of every split (bk).
    edges = {0, 1, 3, 4, 5, 15, 16, 17, 63, 64, 65, n - 1, n}
    edges |= {bk + d for bk in fd_kernel.TILES for d in (-1, 0, 1) if bk + d <= n}
    for length in sorted(edges):
        want = fd_kernel.flash_decode_plain(q, k, v, length)
        for cfg in fd_ops.CANDIDATES:
            got = fd_ops.flash_decode(q, k, v, length, cfg)
            torch.cuda.synchronize()
            assert float((got.float() - want.float()).abs().max()) <= fd_kernel.tolerance(want)
        if length == 0:
            assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_reads_rows_on_4_element_boundaries(cuda_device, dtype):
    """K and V as views whose rows start 4 elements past a 16-byte boundary:
    16-byte copies for float32, the kernel's 8-byte copies for bfloat16."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, n, hk, group, dh = 2, 700, 2, 4, 128
    q = torch.randn((b, hk * group, dh), generator=g, device=cuda_device).to(dtype)
    kv = torch.randn((b, n, 2 * hk, dh + 4), generator=g, device=cuda_device).to(dtype)
    k, v = kv[:, :, :hk, 4:], kv[:, :, hk:, :dh]
    assert (k.data_ptr() // k.element_size()) % 8 == 4 and k.stride(2) % 8 == 4
    for length in (1, 17, 300, n):
        want = fd_kernel.flash_decode_plain(q, k, v, length)
        for cfg in fd_ops.CANDIDATES:
            got = fd_ops.flash_decode(q, k, v, length, cfg)
            torch.cuda.synchronize()
            assert float((got.float() - want.float()).abs().max()) <= fd_kernel.tolerance(want)


def test_uninstantiated_configs_raise_on_the_card(cuda_device):
    x = torch.randn((64, 64), device=cuda_device)
    with pytest.raises(ValueError, match="not instantiated"):
        mm_ops.matmul(x, x, mm_ops.MMConfig(256, 256, 256))
    a = torch.rand((1, 8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="not instantiated"):
        sc_ops.rglru_scan(a, a, a[:, 0], sc_ops.ScanConfig(256, 128))
    q, kv = torch.randn((1, 2, 64), device=cuda_device), torch.randn((1, 8, 1, 64),
                                                                      device=cuda_device)
    with pytest.raises(ValueError, match="not instantiated"):
        fd_ops.flash_decode(q, kv, kv, 8, fd_ops.FDConfig(7))
    qa = torch.randn((1, 64, 1, 64), device=cuda_device)
    with pytest.raises(ValueError, match="not instantiated"):
        fa_ops.flash_attention(qa, qa, qa, config=fa_ops.FAConfig(128, 128))
    # Tiles whose shared memory does not fit a block at dh 256 and 320.
    for dh, tile in ((256, (128, 64)), (256, (64, 128)), (320, (64, 64))):
        qw = torch.randn((1, 64, 1, dh), device=cuda_device)
        with pytest.raises(ValueError, match="not instantiated at dh"):
            fa_kernel.flash_attention_cuda(qw, qw, qw, tile=tile)
    with pytest.raises(ValueError, match="takes dh in"):
        fa_kernel.flash_attention_cuda(*(torch.randn((1, 64, 1, 96), device=cuda_device),) * 3)


def test_altune_margin_small_on_the_card(cuda_device, tmp_path):
    """The margin harvest on the card at the reference's small validation
    shapes: every tile validates and has a measured time; the table saves."""
    before = {f: f.launches for f in (mm_kernel.matmul_cuda, sc_kernel.rglru_scan_cuda,
                                      fd_kernel.flash_decode_cuda,
                                      fa_kernel.flash_attention_cuda)}
    rows, results = altune_margin.run(device=cuda_device, out=str(tmp_path / "t.json"),
                                      shapes=altune_margin.CPU_SHAPES, return_results=True)
    assert all(f.launches > n for f, n in before.items())
    for res in results:
        assert all(e.feasible and e.validated and e.repeat_ok and 0 < e.t_seconds < 1
                   for e in res.entries)
    assert [r[0] for r in rows][::2] == [f"altune/{r.kernel}/margin" for r in results]
    assert (tmp_path / "t.json").exists()



PROFILE_DIMMS = 4096


def _profile_fleet(dev):
    return fleet.synthesize(torch.Generator(device=dev).manual_seed(0), PROFILE_DIMMS,
                            device=dev)


def test_sweep_on_card_matches_cpu(cuda_device):
    """``fleet.sweep`` on the card (one charge-sweep launch) against the
    port's CPU path: the read and write stacks equal except entries one grid
    step apart at a decision threshold (``chip_smoke.sweep_mismatches``),
    the joint stack equal up to one-tCK flips where the CPU's raw minimum is
    at a cycle boundary, the summary within 1e-6."""
    fl = _profile_fleet(cuda_device)
    before = sweep_kernel.charge_sweep_cuda.launches
    cmp = chip_smoke.sweep_card_vs_cpu(fl, fleet.DEFAULT_TEMPS_C, fleet.DEFAULT_PATTERNS)
    assert sweep_kernel.charge_sweep_cuda.launches == before + 1
    print(f"threshold flips: read {cmp['read_flips']}, write {cmp['write_flips']}, joint "
          f"{cmp['joint_flips']}", *cmp["flip_details"], sep="\n")
    assert (cmp["read_bad"], cmp["write_bad"], cmp["joint_bad"]) == (0, 0, 0)
    assert cmp["summary_diff"] <= chip_smoke.MEAN_TOL
    assert cmp["card"].joint.device.type == "cuda"


def test_profile_table_on_card_equals_cpu(cuda_device):
    fl = _profile_fleet(cuda_device)
    card = controller.DimmTimingTable.profile(fl.cells, chip_smoke.BOOT_BINS)
    host = controller.DimmTimingTable.profile(charge.CellParams(*(a.cpu() for a in fl.cells)),
                                              chip_smoke.BOOT_BINS)
    assert card.device.type == "cuda" and host.device.type == "cpu"
    assert card == host
    assert controller.DimmTimingTable.from_json(card.to_json(), device=cuda_device) == card


@pytest.mark.parametrize("cfg", ["SINGLE_CORE", "MULTI_CORE"])
def test_speedup_report_on_card_matches_cpu(cuda_device, cfg):
    card = perfmodel.speedup_report(getattr(perfmodel, cfg), device=cuda_device)
    host = perfmodel.speedup_report(getattr(perfmodel, cfg), device="cpu")
    assert card.keys() == host.keys()
    for k in host:
        assert card[k] == pytest.approx(host[k], abs=chip_smoke.REPORT_TOL), k


def test_sweep_regions_on_card_one_launch_and_anchor(cuda_device):
    """``fleet.sweep_regions`` on the card: one charge-sweep launch for the
    whole (T, P, R, N) grid, the anchor region bitwise the card's
    ``fleet.sweep``, and the CPU's stacks equal up to threshold flips
    (``chip_smoke.sweep_mismatches``)."""
    fl = _profile_fleet(cuda_device)
    before = sweep_kernel.charge_sweep_cuda.launches
    card = fleet.sweep_regions(fl, n_regions=4)
    assert sweep_kernel.charge_sweep_cuda.launches == before + 1
    free = fleet.sweep(fl)
    for k in ("read", "write"):
        assert torch.equal(_bits(getattr(card, k)[:, :, -1]), _bits(getattr(free, k)))
        assert bool((getattr(card, k).diff(dim=2) >= 0).all())
    host_cells = charge.CellParams(*(a.cpu() for a in fl.cells))
    cmp = chip_smoke.sweep_mismatches(card, fleet.sweep_regions(host_cells, n_regions=4),
                                      host_cells)
    print(*(cmp["read"][2] + cmp["write"][2]), sep="\n")
    assert cmp["read"][1] == cmp["write"][1] == 0


def test_region_stream_on_card_matches_cpu(cuda_device):
    """The region stream on the card (one launch of the emitting entry a
    chunk, the chunk's mix added at its effective bins) against the CPU's
    plain region chunk scan: counts, partials and state equal."""
    from repro_torch.core import stream, traces

    fl = _profile_fleet(cuda_device)
    table = controller.DimmTimingTable.profile(fl.cells, chip_smoke.BOOT_BINS, n_regions=4)
    g = torch.Generator().manual_seed(3)
    temps = torch.rand((150, PROFILE_DIMMS), generator=g) * 75.0 + 20.0
    errors = torch.rand(temps.shape, generator=g) < 1e-3
    mix = traces.region_access_mix(None, 150, PROFILE_DIMMS, 4, profile="near",
                                   device=cuda_device)
    before = replay_kernel.replay_chunk_cuda.launches
    card = stream.replay_stream(table, temps, errors, chunk_steps=64, region_mix=mix)
    assert replay_kernel.replay_chunk_cuda.launches == before + -(-150 // 64)
    host = stream.replay_stream(table.to("cpu"), temps, errors, chunk_steps=64,
                                region_mix=mix.cpu())
    assert torch.equal(card.region_counts.cpu(), host.region_counts)
    for a, b in zip(card.partials, host.partials):
        assert torch.equal(_bits(a).cpu(), _bits(b))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card.state, host.state))
    free = stream.replay_stream(table, temps, errors, chunk_steps=64)
    for a, b in zip(card.partials, free.partials):
        assert torch.equal(_bits(a), _bits(b))


def test_kernels_on_second_card(cuda_device):
    """Each of the seven kernels with its tensors on ``cuda:1`` while the
    current device is 0 (what a rank other than 0, or torch ops on an
    explicit device, leave behind), held against its plain version on
    ``cuda:1`` as the one-card tests hold it: every wrapper launches in its
    tensors' context and on their stream."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards, this machine has {torch.cuda.device_count()}")
    second = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    checks = (
        lambda: test_charge_sweep_kernel_matches_plain(second, "mixed lanes"),
        lambda: test_replay_kernel_matches_plain(second, 37, 4099),
        lambda: test_replay_emit_kernel_matches_plain(second, 37, 4099),
        lambda: test_accumulate_kernel_matches_plain(second),
        lambda: test_flash_attention_kernel_matches_plain(second, "causal-g3-dh128"),
        lambda: test_latency_matmul_kernel_matches_plain_on_every_tile(second, torch.float32),
        lambda: test_rglru_scan_kernel_bitwise_equals_plain_on_every_tile(second,
                                                                         torch.float32),
        lambda: test_flash_decode_kernel_matches_plain_on_every_tile(second, torch.float32,
                                                                     8, 128),
    )
    for check in checks:
        check()
        assert torch.cuda.current_device() == 0


def _assert_shard_parity(got, sizes):
    """``chip_smoke.shard_parity``'s results: every map output bitwise, the
    switch totals exact, score floats within ``SHARD_SCORE_TOL``, the
    streamed sharded score bitwise the materialized one."""
    for n in sizes:
        bad = {k: v for k, v in got[n].items() if k not in ("score", "region_score")
               and (v > chip_smoke.SHARD_SCORE_TOL if k.endswith("_err") else v != 0)}
        assert not bad, (n, bad)
    assert got["launches"]["charge_sweep"] and got["launches"]["replay_chunk"]
    assert got["launches"]["accumulate"]


def test_shard_one_card_gloo(cuda_device):
    """Phase 18(a) of chip_smoke: three gloo ranks sharing card 0, a fleet
    that 3 does not divide (4,099 DIMMs) and one smaller than the mesh (2),
    every sharded path against the unsharded card call."""
    from repro_torch.core import shard

    refused = shard.launch(chip_smoke.gloo_cuda_probe, chip_smoke.SHARD_GLOO_RANKS, "cuda:0")
    if refused:
        pytest.skip(f"gloo refuses CUDA tensors on this torch build: {refused}")
    got = shard.launch(chip_smoke.shard_parity, chip_smoke.SHARD_GLOO_RANKS, "cuda:0", "cuda",
                       chip_smoke.SHARD_GLOO_SIZES, chip_smoke.SHARD_STEPS,
                       chip_smoke.SHARD_CHUNKINGS, chip_smoke.ERROR_RATE)
    _assert_shard_parity(got, chip_smoke.SHARD_GLOO_SIZES)


def test_shard_nccl_all_cards(cuda_device):
    """One NCCL rank a card (kernels on ``cuda:0`` to ``cuda:k``), the same
    checks at 65,537 DIMMs."""
    from repro_torch.core import shard

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two or more cards, this machine has {cards}")
    got = shard.launch(chip_smoke.shard_parity, cards, "cuda", "cuda", (65537,),
                       chip_smoke.SHARD_STEPS, chip_smoke.SHARD_CHUNKINGS, chip_smoke.ERROR_RATE)
    _assert_shard_parity(got, (65537,))


def test_stream_staging_waits_for_queued_work(cuda_device):
    """The engine built and fed while the card is still busy (a long sleep
    kernel queued first, so the host runs ahead of the device): the staging
    buffers come from the caching allocator on the compute stream, possibly
    blocks that queued work still uses, and the side stream's first copies
    into them must wait for that work. Decisions equal the replay's, and
    state and partials those of a stream fed with the card idle."""
    from repro_torch.core import stream

    g = torch.Generator(device=cuda_device).manual_seed(7)
    table, temps, errs = _card_replay(g, cuda_device, 5, 96, error_rate=0.02)
    rep = controller.replay(table, temps, errs)
    th, eh = temps.cpu(), errs.cpu()
    for chunk in (1, 37):
        idle = stream.StreamingController(table)
        for a, b in stream.iter_chunks(th, eh, chunk):
            idle.ingest(a, b)
            torch.cuda.synchronize()
        for _ in range(3):
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)   # tens of ms of device time ahead of the host
            busy = stream.StreamingController(table)
            decs = [busy.ingest(a, b, return_decisions=True)
                    for a, b in stream.iter_chunks(th, eh, chunk)]
            assert torch.equal(_bits(torch.cat([d[0] for d in decs])), _bits(rep.timings))
            assert torch.equal(torch.cat([d[1] for d in decs]), rep.bin_idx)
            for a, b in zip((*busy.state, *busy.partials), (*idle.state, *idle.partials)):
                assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b", "recurrentgemma-9b",
                                  "xlstm-125m"])
def test_train_step_on_card_matches_cpu(cuda_device, arch, dtype):
    """One training step of the reduced config on the card and on the CPU
    from the same state and batch, within ``train.STEP_TOL``; with experts,
    a routing flip is admitted only at a CPU near-tie
    (``train.STEP_FLIP_EPS``), and then only the loss and the gradient norm
    are compared (a flipped token's gradients differ)."""
    r = lm_train.compare_card_to_cpu(arch, cuda_device, dtype)
    assert lm_train.within_tolerance(r, dtype), r
    if arch == "deepseek-moe-16b":
        assert r["moe_calls"] == 3


def test_flash_attention_kernel_refuses_autograd(cuda_device):
    """The kernel has no backward pass: with grad on and an input that
    requires grad it raises rather than return an output cut off from q, k
    and v; under no_grad it launches."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((1, 64, 4, 64), generator=g, device=cuda_device)
    k = torch.randn((1, 64, 2, 64), generator=g, device=cuda_device)
    before = fa_kernel.flash_attention_cuda.launches
    with pytest.raises(RuntimeError, match="no backward pass"):
        fa_ops.flash_attention(q.requires_grad_(True), k, k)
    assert fa_kernel.flash_attention_cuda.launches == before
    with torch.no_grad():
        out = fa_ops.flash_attention(q, k, k)
    assert out.grad_fn is None and fa_kernel.flash_attention_cuda.launches == before + 1


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_sharded_train_step_on_card_matches_one_rank(cuda_device, backend):
    """Phase 21 of chip_smoke: one float32 step of reduced smollm-135m and
    deepseek-moe-16b (the expert-parallel branch) on a (2, 2) ``("data",
    "model")`` mesh under ``DEFAULT_RULES`` against the one-rank step on the
    card, within ``train.STEP_TOL["float32"]``: four gloo ranks sharing card
    0, or one NCCL rank a card on four cards."""
    from repro_torch.core import shard

    ranks = chip_smoke.SHARDED_TRAIN_MESH[0] * chip_smoke.SHARDED_TRAIN_MESH[1]
    if backend == "gloo":
        refused = chip_smoke.gloo_dtensor_refusal(ranks)
        if refused:
            pytest.skip(f"gloo cannot run DTensor's collectives on CUDA tensors: {refused}")
        device = "cuda:0"
    else:
        cards = torch.cuda.device_count()
        if cards < ranks:
            pytest.skip(f"needs {ranks} cards for one NCCL rank a card of the "
                        f"{chip_smoke.SHARDED_TRAIN_MESH} mesh, this machine has {cards}")
        device = "cuda"
    got = shard.launch(chip_smoke.sharded_train_parity, ranks, device, "cuda",
                       chip_smoke.SHARDED_TRAIN_COMPARE, chip_smoke.SHARDED_TRAIN_BATCH,
                       chip_smoke.SHARDED_TRAIN_SEQ)
    for arch, r in got["compare"].items():
        assert lm_train.within_tolerance(r, "float32"), (arch, r)
    assert not any(got["launches"].values()), got["launches"]


def test_elastic_restore_on_card(cuda_device, tmp_path):
    """Parameters saved on four ranks under a (2, 2) mesh restore bitwise
    under (4, 1) and (1, 4), each leaf placed as the new mesh's policy
    says, on the cards: one NCCL rank a card on four cards, else four gloo
    ranks sharing card 0 where gloo runs DTensor's collectives on CUDA
    tensors. On the same ranks, the error fuse of ``train(mesh=)`` with
    rank 0's checkpoint write pending restores one step on every rank
    (``chip_smoke.fuse_restore``)."""
    from repro_torch.core import shard

    if torch.cuda.device_count() >= 4:
        device = "cuda"
    else:
        refused = chip_smoke.gloo_dtensor_refusal(4)
        if refused:
            pytest.skip(f"fewer than 4 cards, and gloo cannot run DTensor's collectives on "
                        f"CUDA tensors: {refused}")
        device = "cuda:0"
    got = shard.launch(chip_smoke.sharded_train_parity, 4, device, "cuda", (),
                       chip_smoke.SHARDED_TRAIN_BATCH, chip_smoke.SHARDED_TRAIN_SEQ, None,
                       str(tmp_path / "ckpt"), None, str(tmp_path / "fuse"))
    for shape, r in got["elastic"].items():
        assert r["leaves"] and r["mismatches"] == 0 and r["wrong_placements"] == 0, (shape, r)
    at = chip_smoke.FUSE_STEP
    assert got["fuse"]["skipped"] == [at], got["fuse"]
    assert got["fuse"]["restored_by_rank"] == [[(at, 0)]] * 4, got["fuse"]
    assert "escaped placement" in got["escaped"]

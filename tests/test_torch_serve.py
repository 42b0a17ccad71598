"""The port's serving path against the reference's, on the reduced bf16
configs.

``Server`` of both packages serves the same two requests in two slots
with the same parameters (the reference's, loaded into the port).  Two
slots hold the reference's cross-slot behaviour too: every step runs all
rows and keeps the whole new cache, so each request's output depends on
the other's (ROADMAP.md, Queue 3).

Criteria, with their reasons: per-step logits agree within 6.25e-2, two
bf16 ulps at |logit| < 8 (the packages round bf16 products and
transcendentals — rotary's cos/sin — at different places; measured up to
~1.4 ulps).  The two servers decode in lockstep, and the port is fed the
reference's token at every step, so every step of both slots stays
comparable: a step whose greedy tokens differ must be a near tie (the
two candidates within that tolerance in the reference's own logits), and
the tokens agree on at least 90% of the steps.  mamba2-1.3b's decode
path has no such rounding difference, and its tokens agree everywhere.
deepseek-moe-16b's moe layer gives the reference's bits on the same
input (``tests/test_torch_moe.py``, which also catches its subtle bf16
faults: gates cast before they are renormalised, a float32 combine) and
no routing decision differs over these steps, but the attention's
rounding differences grow larger through it: the logits are held to four
bf16 ulps at |logit| < 8 (measured up to 0.0703, at the last step).  The
faults of the moe serving path that this limit is there to catch read
2.03 and more (``test_moe_server_limit_fails_planted_faults``); the
subtle ones above read 0.0625-0.0781, inside either limit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.step import Request as RefRequest  # noqa: E402
from repro.serve.step import Server as RefServer  # noqa: E402

from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serve.step import Request, Server  # noqa: E402
from test_torch_models import _pair  # noqa: E402

TOL = 6.25e-2
#: per arch where it is not TOL
ARCH_TOL = {"deepseek-moe-16b": 1.25e-1}
N_SLOTS, PROMPT, MAX_NEW = 2, 8, 8


def _recording(srv, port):
    """Wrap ``srv._decode`` so each step's logits land in the returned
    list as float32 numpy."""
    record, decode = [], srv._decode
    if port:
        def recording(tokens, index):
            logits = decode(tokens, index)
            record.append(logits.float().numpy())
            return logits
    else:
        def recording(*args):
            logits, cache = decode(*args)
            record.append(np.asarray(logits, np.float32))
            return logits, cache
    srv._decode = recording
    return record


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-1.3b",
                                  "deepseek-moe-16b"])
def test_server_matches_reference(arch):
    rm, params, pm = _pair(arch)
    V = pm.cfg.vocab_size
    tol = ARCH_TOL.get(arch, TOL)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, PROMPT) for _ in range(N_SLOTS)]
    ref = RefServer(rm, params, n_slots=N_SLOTS, s_max=32)
    out = Server(pm, n_slots=N_SLOTS, s_max=32)
    ref_log, out_log = _recording(ref, port=False), _recording(out, port=True)
    for i, p in enumerate(prompts):
        assert ref.add_request(RefRequest(i, p, max_new=MAX_NEW))
        assert out.add_request(Request(i, p, max_new=MAX_NEW))
    n_prefill = N_SLOTS * PROMPT
    assert len(ref_log) == len(out_log) == n_prefill
    # prefill steps (all rows; the cross-slot writes included)
    for step in range(n_prefill):
        np.testing.assert_allclose(out_log[step], ref_log[step], atol=tol,
                                   rtol=0)
    agree = 0
    for r in range(MAX_NEW):
        assert ref.decode_round() == out.decode_round() == N_SLOTS
        for slot in range(N_SLOTS):
            ref_row = ref_log[-1][slot, 0, :V]
            np.testing.assert_allclose(out_log[-1][slot, 0, :V], ref_row,
                                       atol=tol, rtol=0, err_msg=str(
                                           (slot, r)))
            want = ref.slots[slot].generated[-1]
            got = out.slots[slot].generated[-1]
            if got == want:
                agree += 1
            else:                 # a near tie; go on from the reference's
                assert ref_row[got] >= ref_row[want] - tol, (slot, r)
                out.slots[slot].generated[-1] = want
    assert ref.decode_round() == out.decode_round() == 0
    steps = N_SLOTS * MAX_NEW
    if pm.cfg.family == "ssm":
        assert agree == steps
    assert agree >= 0.9 * steps, f"tokens agree on {agree} of {steps} steps"


def _max_drift(arch):
    """The largest |logit| difference between the port's server and the
    reference's over every step of ``test_server_matches_reference``'s
    run, the port fed the reference's tokens."""
    rm, params, pm = _pair(arch)
    V = pm.cfg.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, PROMPT) for _ in range(N_SLOTS)]
    ref = RefServer(rm, params, n_slots=N_SLOTS, s_max=32)
    out = Server(pm, n_slots=N_SLOTS, s_max=32)
    ref_log, out_log = _recording(ref, port=False), _recording(out, port=True)
    for i, p in enumerate(prompts):
        assert ref.add_request(RefRequest(i, p, max_new=MAX_NEW))
        assert out.add_request(Request(i, p, max_new=MAX_NEW))
    for _ in range(MAX_NEW):
        ref.decode_round()
        out.decode_round()
        for slot in range(N_SLOTS):
            out.slots[slot].generated[-1] = ref.slots[slot].generated[-1]
    return max(float(np.abs(o[..., :V] - r[..., :V]).max())
               for o, r in zip(out_log, ref_log))


def _slot_mates_experts(route):
    def planted(x2d, w, k):
        e, g, aux = route(x2d, w, k)
        return torch.roll(e, 1, 0), torch.roll(g, 1, 0), aux
    return planted


def _last_expert_dropped(route):
    def planted(x2d, w, k):
        e, g, aux = route(x2d, w, k)
        g = g.clone()
        g[:, -1] = 0
        return e, g, aux
    return planted


def _shared_experts_skipped(ffn):
    def planted(p, x, cfg):
        return ffn({n: p[n] for n in p.keys() if not n.startswith("ws_")},
                   x, cfg)
    return planted


@pytest.mark.parametrize("attr,fault", [
    ("_route", _slot_mates_experts), ("_route", _last_expert_dropped),
    ("moe_ffn", _shared_experts_skipped)])
def test_moe_server_limit_fails_planted_faults(monkeypatch, attr, fault):
    """deepseek-moe-16b's limit in ``test_server_matches_reference`` fails
    a serving path with a planted fault in its moe layers: every decode
    step routes each row with its slot-mate's experts, drops each row's
    last chosen expert, or skips the shared experts (they read 2.03 and
    more, over ten times the limit; the sound path 0.0703)."""
    from repro_torch.models import moe as moe_mod
    monkeypatch.setattr(moe_mod, attr, fault(getattr(moe_mod, attr)))
    assert _max_drift("deepseek-moe-16b") > 10 * ARCH_TOL["deepseek-moe-16b"]


def test_request_timestamps_and_slot_limit():
    _, _, pm = _pair("mamba2-1.3b")
    clock = iter(float(t) for t in range(100))
    srv = Server(pm, n_slots=1, s_max=16, now=lambda: next(clock))
    a = Request(0, np.arange(3, dtype=np.int32), max_new=2, arrival_s=-1.0)
    assert srv.add_request(a)
    assert not srv.add_request(Request(1, np.arange(3, dtype=np.int32)))
    while srv.decode_round():
        pass
    assert a.done and len(a.generated) == 2
    assert a.admitted_s == 0.0 and a.latency_s == a.done_s + 1.0
    assert srv.steps == 3 + 2


def test_cli_serves_on_cpu(capsys):
    serve_cli.main(["--arch", "mamba2-1.3b", "--requests", "3",
                    "--slots", "2", "--prompt-len", "4", "--max-new", "3",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "3 requests, 21 tokens" in out
    # --open-loop feeds the decode loop from the open-loop generator
    serve_cli.main(["--arch", "mamba2-1.3b", "--open-loop", "200",
                    "--requests", "6", "--slots", "2", "--prompt-len", "4",
                    "--max-new", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "open-loop preprocessing @ 200 req/s" in out
    assert "latency p50=" in out
    assert "6 requests, 36 tokens" in out


def test_cli_requests_match_reference_prompts():
    reqs = serve_cli.make_requests(3, 12, 512)
    rng = np.random.default_rng(0)
    for r in reqs:
        np.testing.assert_array_equal(r.prompt, rng.integers(0, 512, 12))

"""The MBPO loop's agent on the card:
- one DrQ-v2 update at MBPOConfig's widths (hidden 1024, feature 50,
  64 x 64 x 9 stacks, batch 64) against the same update on the CPU from the
  same weights and draws;
- an imagination rollout dispatched with the agent's live policy, then an
  agent update queued behind it, neither waiting for the card: the rollout
  equals one run with a frozen copy of the policy;
- the agent's and the world model's snapshots round-tripped on the card.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips when there is none. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_*.py
"""

import copy

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

OBS, A = (64, 64, 9), 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, *OBS)).astype(np.uint8),
            rng.uniform(-1, 1, (n, A)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32),
            np.full((n, 1), 0.99 ** 3, np.float32),
            rng.integers(0, 256, (n, *OBS)).astype(np.uint8))


def _agents(device):
    from ivideogpt_tpu_torch.mbrl.drqv2 import DrQV2Agent
    card = DrQV2Agent(OBS, A, seed=0, device=device)
    host = DrQV2Agent(OBS, A, seed=1, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return card, host


def test_agent_update_on_the_card_matches_the_cpu(cuda):
    """fp32, TF32 off on both sides. Metrics within 1e-4 relative; each
    tensor's gradient (AdamW's first moment after one step, 0.1 g) within
    1e-2 of its norm (the tokenizer checks' tolerance: ReLUs at near-zero
    activations), and in no tensor more than 1 % of the gradients above
    rounding level (1e-5 of the tensor's largest) differing by more than
    1 %; the updated parameters within 1e-6 beyond the difference that
    AdamW's first step, lr g / (|g| + eps), makes of the card's gradient g
    and the CPU's h: a few 1e-7 where they agree to 1 %, up to 2 lr where
    they differ in sign."""
    from ivideogpt_tpu_torch.mbrl.drqv2 import update_draws
    card, host = _agents(cuda)
    batch = _batch(64, 0)
    draws = update_draws(64, A, torch.Generator().manual_seed(2))
    m_cpu = host.update_step(tuple(torch.from_numpy(x) for x in batch), 0.3,
                             draws, True)
    m_card = card.update_step(
        tuple(torch.from_numpy(x).to(cuda) for x in batch), 0.3,
        type(draws)(*(d.to(cuda) for d in draws)), True)
    for k, v in m_cpu.items():
        assert abs(float(m_card[k]) - float(v)) <= 1e-4 * max(abs(float(v)),
                                                              1e-3), k
    for name in ("encoder", "actor", "critic"):
        sc, sh = card.train_states()[name], host.train_states()[name]
        for i, (p, q) in enumerate(zip(sc.params, sh.params)):
            g = sc.optimizer.state[p]["exp_avg"].cpu().double() * 10
            h = sh.optimizer.state[q]["exp_avg"].double() * 10
            assert (g - h).norm() <= 1e-2 * h.norm() + 1e-12, (name, i)
            loose = ((h.abs() > 1e-5 * h.abs().max())
                     & ((g - h).abs() > 1e-2 * h.abs()))
            assert loose.double().mean() <= 1e-2, (name, i)
            step = 1e-4 * (g / (g.abs() + 1e-8) - h / (h.abs() + 1e-8)).abs()
            err = (p.detach().cpu().double() - q.detach().double()).abs()
            assert (err - step).max() <= 1e-6, (name, i, err.max())
    for p, q in zip(card.critic_target.parameters(),
                    host.critic_target.parameters()):
        assert (p.detach().cpu() - q).abs().max() <= 1e-6


def test_rollout_reads_the_policy_of_its_dispatch(cuda):
    """The rollout (B=4, horizon 3, TOKENIZER_64 and LLAMA_BASE widths at 2
    layers, bf16, int8 cache) is dispatched with the agent's live policy and
    an agent update is queued behind it, both under the sync debug mode
    "error": its result equals a rollout run with a frozen copy of the
    policy as it was at the dispatch."""
    from ivideogpt_tpu_torch.configs import (LLAMA_BASE, TOKENIZER_64,
                                             ActionModelConfig)
    from ivideogpt_tpu_torch.mbrl import drqv2
    from ivideogpt_tpu_torch.mbrl.video_predictor import VideoPredictor
    from ivideogpt_tpu_torch.utils.platform import to_device
    B, H = 4, 3
    head = ActionModelConfig(action_dim=A, context_length=2,
                             segment_length=2 + H, reward_prediction=True)
    vp = VideoPredictor(TOKENIZER_64, LLAMA_BASE.replace(num_hidden_layers=2),
                        head, seed=0)
    agent = drqv2.DrQV2Agent(OBS, A, seed=3, device=cuda)
    frozen = copy.deepcopy(agent.policy)
    obs = np.random.default_rng(4).integers(0, 256, (B, *OBS)).astype(
        np.uint8)
    batch = _batch(32, 5)
    draws = drqv2.update_draws(32, A, torch.Generator(cuda).manual_seed(6))
    host_batch = tuple(torch.from_numpy(x).pin_memory() for x in batch)

    def dispatch(policy):
        return vp.rollout_async(obs, drqv2.batched_policy, policy, H,
                                frame_stack=3, policy_stddev=0.2,
                                generator=torch.Generator(
                                    cuda).manual_seed(7))

    want = dispatch(frozen).fetch()
    torch.cuda.synchronize()
    before = [p.detach().clone() for p in agent.policy.parameters()]
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = dispatch(agent.policy)
        agent.update_step(tuple(to_device(x, cuda) for x in host_batch), 0.2,
                          draws, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for got, w in zip(pending.fetch(), want):
        np.testing.assert_array_equal(got, w)
    assert any(not torch.equal(p, q) for p, q in
               zip(agent.policy.parameters(), before))


def test_snapshots_round_trip_on_the_card(cuda, tmp_path):
    from ivideogpt_tpu_torch.configs import (LLAMA_BASE, TOKENIZER_64,
                                             ActionModelConfig)
    from ivideogpt_tpu_torch.mbrl.drq_workspace import (load_agent_snapshot,
                                                        save_agent_snapshot)
    from ivideogpt_tpu_torch.mbrl.drqv2 import DrQV2Agent
    from ivideogpt_tpu_torch.mbrl.video_predictor import VideoPredictor
    agent = DrQV2Agent(OBS, A, seed=8, device=cuda)
    np.random.seed(0)
    agent.update(_batch(32, 9), 0)
    save_agent_snapshot(tmp_path, agent, {"_global_step": 5,
                                          "_global_episode": 1})
    other = DrQV2Agent(OBS, A, seed=10, device=cuda)
    _, counters = load_agent_snapshot(tmp_path, other)
    assert counters == {"_global_step": 5, "_global_episode": 1}
    assert other.updated_steps == 1
    for k, v in agent.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    batch = _batch(32, 11)
    out = []
    for a in (agent, other):
        np.random.seed(1)
        out.append(a.update(batch, 1))
    assert out[0] == out[1]

    head = ActionModelConfig(action_dim=A, context_length=2,
                             segment_length=5, reward_prediction=True)
    lm = LLAMA_BASE.replace(num_hidden_layers=2)
    vp = VideoPredictor(TOKENIZER_64, lm, head, seed=0, max_target_frames=2)
    g = torch.Generator(cuda).manual_seed(12)
    seg = (torch.randint(0, 256, (2, 5, 64, 64, 3), generator=g,
                         device=cuda).float(),
           torch.rand(2, 5, A, generator=g, device=cuda) * 2 - 1,
           torch.randn(2, 5, generator=g, device=cuda))
    vp.train(seg)
    vp.save_snapshot(str(tmp_path), 7)
    vp2 = VideoPredictor(TOKENIZER_64, lm, head, seed=1, max_target_frames=2)
    assert vp2.load_snapshot(str(tmp_path)) == 7
    for a, b in ((vp.model_state, vp2.model_state),
                 (vp.tok_state, vp2.tok_state)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa["updates"] == sb["updates"] == 1
        for k, v in sa["model"].items():
            assert torch.equal(sb["model"][k], v), k
        for i, entry in sa["optimizer"]["state"].items():
            for k, v in entry.items():
                assert torch.equal(torch.as_tensor(
                    sb["optimizer"]["state"][i][k]), torch.as_tensor(v))
    for p, q in zip(vp.rollout_model.parameters(),
                    vp2.rollout_model.parameters()):
        assert torch.equal(p, q)

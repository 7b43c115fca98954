"""The port's inference CLI (``ivideogpt_tpu_torch/inference``) against the
JAX package's (``inference/``), on the tiny hub of ``tools/make_fake_hub.py``
and ``inference/samples/synthetic_sample*.npz``:
- ``NPZParser`` (resize written without ``cv2``) matches the JAX parser
  (``cv2.INTER_LINEAR``) within 1e-5 at 64->64, 96->64, 80->64, an upscale
  and the robonet crop;
- ``predict``: fp32 token ids bit-equal to JAX's ``tokenize``; the JAX
  package's ``replay_logits`` over the port's own sampled stream within
  1e-3 of the port's teacher-forced logits (bf16 cache, as
  ``tests/test_torch_rollout.py``), every sampled token in JAX's top-k
  set; JAX's ``detokenize`` of the stream within 1e-4 of the port's frames;
- the CLI, in-process on the CPU, writes non-empty GIFs.
Streams drawn from the same seed in the two packages are never compared.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inference.utils import NPZParser as JaxParser
from ivideogpt_tpu import generation as jgen
from ivideogpt_tpu_torch import generation as tgen
from ivideogpt_tpu_torch.inference import predict as tpredict
from ivideogpt_tpu_torch.inference.utils import NPZParser

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = [os.path.join(REPO, "inference", "samples", f)
           for f in ("synthetic_sample.npz", "synthetic_sample2.npz")]
T, R, TOP_K = 6, 2, 10


@pytest.fixture(scope="module")
def hub(tmp_path_factory):
    from tools.make_fake_hub import make_fake_hub
    return make_fake_hub(str(tmp_path_factory.mktemp("hub")), size="tiny",
                         action_conditioned=True)


def _args(hub, **kw):
    base = dict(pretrained_model_name_or_path=hub, context_length=2,
                segment_length=T, resolution=64, action_conditioned=True,
                action_dim=4, repeat_times=R, top_k=TOP_K, temperature=1.0,
                seed=0, device="cpu")
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("size", [64, 96, 80, 48])
@pytest.mark.parametrize("dataset", ["bair_robot_pushing", "fractal20220817_data"])
def test_npz_parser_matches_jax(tmp_path, size, dataset):
    """Display key, stepsize, padding of a short episode and resize. The
    tolerance: the two resizes take the same taps in float32, in another
    order where cv2 sends an exact 2x downscale to its area path."""
    rng = np.random.default_rng(size)
    key = "aux1_image" if dataset == "bair_robot_pushing" else "image"
    path = str(tmp_path / "ep.npz")
    np.savez(path, **{key: rng.integers(0, 256, (9, size, size, 3),
                                        dtype=np.uint8),
                      "action": rng.normal(size=(9, 4)).astype(np.float32)})
    for seg in (4, 12):
        ours, ours_act = NPZParser(seg, 64).parse(path, dataset, True)
        theirs, their_act = JaxParser(seg, 64).parse(path, dataset, True)
        assert ours.shape == theirs.shape == (seg, 64, 64, 3)
        assert ours.dtype == np.float32
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(ours_act, their_act)
        assert NPZParser(seg, 64).parse(path, dataset)[1] is None


def test_npz_parser_robonet_crop_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "robonet.npz")
    np.savez(path, image=rng.integers(0, 256, (5, 96, 128, 3),
                                      dtype=np.uint8))
    ours, _ = NPZParser(5, 64).parse(path, "tfds_robonet")
    theirs, _ = JaxParser(5, 64).parse(path, "tfds_robonet")
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def run(hub):
    """The port's predict and the JAX package's models on the same hub."""
    import inference.predict as jpredict
    args = _args(hub)
    pixels, actions = NPZParser(T, 64).parse(SAMPLES[0], "bair", True)
    tok, model = tpredict.load_models(args)
    res = tpredict.predict(args, tok, model, pixels, actions)
    jtok, jtok_params, jmodel, jlm_params, _ = jpredict.load_models(args)
    return dict(args=args, pixels=pixels, actions=actions, tok=tok,
                model=model, res=res, jtok=jtok, jtok_params=jtok_params,
                jmodel=jmodel, jlm_params=jlm_params)


def test_predict_token_ids_equal_jax_tokenize(run):
    """All T frames in fp32: the context grid and the dynamics grid."""
    m = run["jtok"]
    px = jnp.asarray(run["pixels"])[None]
    theirs, _ = jax.jit(lambda p, x: m.apply(p, x, 2, method=m.tokenize))(
        run["jtok_params"], px)
    with torch.no_grad():
        ours, _ = run["tok"].tokenize(torch.from_numpy(run["pixels"])[None],
                                      2)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # the prelude of every sample is the clip's own
    P1 = 257 * 2
    stream = run["res"].tokens.numpy()
    assert stream.shape == (R, P1 - 1 + 17 * (T - 2))
    np.testing.assert_array_equal(stream[:, :P1],
                                  np.tile(ours.numpy()[:, :P1], (R, 1)))


def test_predict_logits_and_top_k_against_jax_replay(run):
    tokens = run["res"].tokens
    act = np.tile(run["actions"][None], (R, 1, 1))
    theirs = np.asarray(jgen.replay_logits(
        run["jmodel"], run["jlm_params"], jnp.asarray(tokens.numpy()),
        segment_length=T, context_length=2, action=jnp.asarray(act),
        tokens_per_dyna=16, cache_dtype=jnp.bfloat16))
    ours = tgen.replay_logits(run["model"], tokens, segment_length=T,
                              context_length=2, action=torch.from_numpy(act),
                              tokens_per_dyna=16, cache_dtype=torch.bfloat16)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-3, rtol=1e-3)
    P1 = 257 * 2
    stream = tokens.numpy()
    for s in range(theirs.shape[0]):
        if s % 17 == 16:
            continue  # a forced sdf, not sampled
        keys, kth = jgen.exact_kth_largest_key(jnp.asarray(theirs[s]), TOP_K)
        keep = np.asarray(keys >= kth[:, None])
        assert keep[np.arange(R), stream[:, P1 + s]].all(), s


def test_predict_frames_equal_jax_detokenize(run):
    m = run["jtok"]
    theirs = jax.jit(lambda p, i: m.apply(p, i, 2, method=m.detokenize))(
        run["jtok_params"], jnp.asarray(run["res"].tokens.numpy()))
    frames = run["res"].frames
    assert frames.shape == (R, T, 64, 64, 3) and frames.dtype == np.float32
    np.testing.assert_allclose(frames, np.clip(np.asarray(theirs), 0, 1),
                               atol=1e-4, rtol=0)


def test_gif_strips(run):
    strips = tpredict.gif_strips(run["pixels"], run["res"].frames)
    assert len(strips) == R and len(strips[0]) == T
    assert strips[0][0].shape == (64, 128, 3)
    assert strips[0][0].dtype == np.uint8
    np.testing.assert_array_equal(strips[1][3][:, :64],
                                  (run["pixels"][3] * 255).astype(np.uint8))


@pytest.mark.parametrize("conditioned", [True, False])
def test_cli_writes_gifs_on_the_cpu(hub, tmp_path, conditioned):
    """``python -m ivideogpt_tpu_torch.inference.predict``, in-process with
    ``--device cpu``; action-free over the action-model export too."""
    out = tmp_path / "gifs"
    argv = ["--pretrained_model_name_or_path", hub,
            "--input_path", SAMPLES[1], "--dataset_name", "bair",
            "--output_path", str(out), "--segment_length", str(T),
            "--repeat_times", "2", "--top_k", "10", "--device", "cpu"]
    if conditioned:
        argv += ["--action_conditioned", "--goal_conditioned"]
    tpredict.main(argv)
    gifs = sorted(out.glob("*.gif"))
    assert [g.name for g in gifs] == ["pred-samples-0.gif",
                                      "pred-samples-1.gif"]
    assert all(g.stat().st_size > 0 for g in gifs)


def test_cli_defaults_to_cuda():
    args = tpredict.parse_args(["--pretrained_model_name_or_path", "x",
                                "--input_path", "y", "--dataset_name", "z"])
    assert args.device == "cuda" and args.repeat_times == 5
    assert args.top_k == 100 and args.context_length == 2

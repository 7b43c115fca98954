"""One rank of the PyTorch port's multi-process CPU tests
(``tests/test_torch_parallel*.py``), spawned as a subprocess over gloo:

    python tests/torch_parallel_worker.py <job> <host:port> <world> <rank> <dir>

reads ``<dir>/inputs.pt`` (written by the test), runs ``<job>`` (a
function of this module named ``job_<job>``) on this rank and writes
``<dir>/out-<rank>.pt``. The worker imports torch and the port only, never
JAX: the tests hold its results against the JAX package in their own
process. :func:`run_ranks` spawns the ranks with a timeout on each
process and on the process group, and kills every rank when one hangs or
fails, so a hang fails its test instead of running the suite into its time
limit.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import socket
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the JAX multi-process worker's GPT (tests/multiproc_worker.py:74-82)
CTX, T, NCTX, NDYN, ACTION_DIM = 2, 4, 16, 4, 4
GB = 8  # the global batch
LM = dict(vocab_size=64 + 64 + 2, hidden_size=128, intermediate_size=256,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
          max_position_embeddings=128, attention_dropout=0.0)
HEAD = dict(action_dim=ACTION_DIM, context_length=CTX, segment_length=T,
            tokens_per_context=NCTX, tokens_per_dyna=NDYN)
# the group's and each rank's time limits, seconds
GROUP_TIMEOUT = 60
RANK_TIMEOUT = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(job: str, world: int, out_dir, inputs=None,
              timeout: float = RANK_TIMEOUT):
    """Spawn ``world`` ranks of ``job`` over gloo on this host; returns
    their outputs in rank order. Kills every rank and fails when one
    exits non-zero or the ranks outlast ``timeout`` seconds."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    if inputs is not None:
        torch.save(inputs, os.path.join(out_dir, "inputs.pt"))
    coord = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_", "MASTER_", "WORLD_SIZE",
                                "RANK", "LOCAL_RANK"))}
    env["OMP_NUM_THREADS"] = "2"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, coord, str(world),
         str(rank), out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               1))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{job}: the ranks outlasted {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{job} rank {rank} failed:\n{log}"
    return [torch.load(os.path.join(out_dir, f"out-{r}.pt"),
                       weights_only=False) for r in range(world)]


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def lm_model(lm_json=None, head_json=None, state_dict=None):
    from ivideogpt_tpu_torch.configs import (ActionModelConfig,
                                             TransformerConfig)
    from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
    lm = (TransformerConfig.from_json(lm_json) if lm_json
          else TransformerConfig(**LM))
    head = (ActionModelConfig.from_json(head_json) if head_json
            else ActionModelConfig(**HEAD))
    model = HeadModelWithAction(lm, head)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def train_state(model, lr):
    from ivideogpt_tpu_torch.train.optim import TrainState
    return TrainState(model, learning_rate=lr, lr_scheduler="cosine",
                      warmup_steps=1, total_steps=10, weight_decay=0.01,
                      max_grad_norm=1.0)


def gpt_run(inp, mesh):
    """``inp["steps"]`` GPT train steps of this rank's rows from
    ``inp["state_dict"]``: losses, grad norms, the full parameters after
    them (a collective) and this rank's parameters' digest."""
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    from ivideogpt_tpu_torch.train.gpt_trainer import train_step
    model = lm_model(inp.get("lm_json"), None, inp["state_dict"])
    mesh_lib.shard_params(model, mesh)
    state = mesh_lib.place_state(train_state(model, inp["lr"]), mesh)
    batch = mesh_lib.shard_batch(inp["batch"], mesh)
    losses, norms = [], []
    for i in range(inp["steps"]):
        m = train_step(state, batch, rng=(inp["seed"], i), mesh=mesh)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = mesh_lib.HostState(state, mesh).state_dict()
    return {"losses": losses, "grad_norms": norms,
            "params": full["model"], "optimizer": full["optimizer"],
            "digest": digest(state.params), "mesh": mesh.shape,
            "data_rank": mesh.data_rank, "model_rank": mesh.model_rank}


def lora_run(inp, mesh=None):
    """``inp["steps"]`` LoRA steps (rank 4 adapters over the whole base on
    every rank) of this rank's rows: losses and the adapters' digest."""
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    from ivideogpt_tpu_torch.train import lora
    from ivideogpt_tpu_torch.train.gpt_trainer import lora_train_step
    model = lm_model(inp.get("lm_json"), None, inp["state_dict"])
    adapters = lora.init_lora(model, torch.Generator().manual_seed(0),
                              rank=4, alpha=8.0)
    lora.attach(model, adapters)
    state = train_state(adapters, inp["lr"])
    batch, kw = inp["batch"], {}
    if mesh is not None:
        mesh_lib.place_state(state, mesh)
        batch, kw = mesh_lib.shard_batch(batch, mesh), {"mesh": mesh}
    losses = [float(lora_train_step(state, model, batch, rng=(inp["seed"], i),
                                    **kw)["loss"])
              for i in range(inp["steps"])]
    return {"losses": losses, "digest": digest(state.params),
            "adapters": {k: v.detach().clone()
                         for k, v in adapters.state_dict().items()}}


def job_gpt(inp, rank):
    """The GPT steps of each entry of ``inp["runs"]`` (n_model, lm_json)."""
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    out = []
    for run in inp["runs"]:
        mesh = mesh_lib.make_global_mesh(run["n_model"])
        out.append((lora_run if run.get("lora") else gpt_run)(
            {**inp, **run}, mesh))
    return out


def tokenizer_models(inp):
    """The tokenizer, discriminator and LPIPS of ``inp``'s configs and
    state dicts, fp32 on the CPU."""
    from ivideogpt_tpu_torch.configs import (CompressiveVQConfig,
                                             DiscriminatorConfig)
    from ivideogpt_tpu_torch.models.discriminator import Discriminator
    from ivideogpt_tpu_torch.models.lpips import LPIPS
    from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
    tok = CompressiveVQModel(CompressiveVQConfig.from_json(inp["tok_json"]))
    tok.load_state_dict(inp["tok_sd"])
    disc = Discriminator(DiscriminatorConfig.from_json(inp["disc_json"]))
    disc.load_state_dict(inp["disc_sd"])
    lpips = LPIPS()
    lpips.load_state_dict(inp["lpips_sd"])
    lpips.requires_grad_(False)
    return tok.train(), disc.train(), lpips.eval()


def tokenizer_run(inp, mesh=None, steps=3):
    """``steps`` alternating G (GAN on), D, G steps of this rank's rows:
    each step's metrics and the digests of both models after them."""
    from ivideogpt_tpu_torch.configs import TokenizerTrainConfig
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    from ivideogpt_tpu_torch.train import tokenizer_trainer as tt
    tok, disc, lpips = tokenizer_models(inp)
    cfg = TokenizerTrainConfig.from_json(inp["train_json"])
    state, disc_state = tt.create_train_states(tok, disc, cfg)
    kw = {} if mesh is None else {"mesh": mesh}
    g_step = tt.make_generator_step(tok, disc, lpips, cfg, use_gan=True, **kw)
    d_step = tt.make_discriminator_step(tok, disc, cfg, **kw)
    px = inp["pixels"] if mesh is None else mesh_lib.shard_batch(
        inp["pixels"], mesh)
    metrics = []
    for i in range(steps):
        gen = torch.Generator().manual_seed(i)
        m = (g_step(state, px, gen) if i % 2 == 0
             else d_step(disc_state, px, gen))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "tok": digest(tok.parameters()),
            "disc": digest(disc.parameters()),
            "disc_buffers": digest(disc.buffers()),
            "tok_sd": {k: v.clone() for k, v in tok.state_dict().items()}}


def job_tokenizer(inp, rank):
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    return tokenizer_run(inp, mesh_lib.make_global_mesh(1))


def job_logits(inp, rank):
    """Teacher-forced logits of the whole batch through a TP=world model."""
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_global_mesh(inp["n_model"])
    model = lm_model(None, None, inp["state_dict"]).eval()
    mesh_lib.shard_params(model, mesh)
    b = inp["batch"]
    with torch.no_grad():
        logits = model(b["input_ids"], None, b["action"])["logits"]
    return {"logits": logits}


def job_generate(inp, rank):
    """``sharded_generate`` at (n_model) with a seeded generator, fp32
    cache; its rows' stream."""
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    from ivideogpt_tpu_torch.parallel import serving
    mesh = mesh_lib.make_global_mesh(inp["n_model"])
    model = lm_model(None, None, inp["state_dict"]).eval()
    serving.place_inference_params(model, mesh)
    res = serving.sharded_generate(
        model, inp["prelude"], mesh=mesh,
        generator=torch.Generator().manual_seed(inp["seed"]),
        action=inp["action"], segment_length=T, context_length=CTX,
        tokens_per_dyna=NDYN, top_k=5, cache_dtype=torch.float32)
    err = None
    try:
        serving.sharded_generate(
            model, inp["prelude"][:3], mesh=mesh,
            generator=torch.Generator().manual_seed(0),
            action=inp["action"][:3], segment_length=T, context_length=CTX,
            tokens_per_dyna=NDYN, top_k=5)
    except ValueError as e:
        err = str(e)
    return {"tokens": res.tokens, "rows": mesh_lib.batch_rows(
        inp["prelude"].shape[0], mesh), "error": err}


def job_rollout(inp, rank):
    """``sharded_rollout`` of every entry of ``inp["runs"]``."""
    from ivideogpt_tpu_torch.configs import CompressiveVQConfig
    from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    from ivideogpt_tpu_torch.parallel import serving
    out = []
    for run in inp["runs"]:
        mesh = mesh_lib.make_global_mesh(run["n_model"])
        tok = CompressiveVQModel(CompressiveVQConfig.from_json(
            run["tok_json"]))
        tok.load_state_dict(run["tok_sd"])
        model = lm_model(run["lm_json"], run["head_json"], run["lm_sd"])
        serving.place_inference_params(model.eval(), mesh)
        frames, res = serving.sharded_rollout(
            tok.eval(), model, run["pixels"], mesh=mesh,
            generator=torch.Generator().manual_seed(4),
            segment_length=run["T"], context_length=run["ctx"],
            action=run["action"], top_k=5, cache_dtype=torch.float32)
        out.append({"frames": frames, "tokens": res.tokens})
    return out


def job_util(inp, rank):
    """The collectives: an uneven gather, params_to_host of a TP=world
    model, rank 0's timestamp, and a DP mean."""
    from ivideogpt_tpu_torch.parallel import distributed as dl
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    import numpy as np
    rows = np.full((rank + 1, 3), rank, np.float32)  # rank r: r + 1 rows
    gathered = dl.gather_across_processes(rows)
    t_gathered = dl.gather_across_processes(torch.arange(2 * rank + 1))
    mesh = mesh_lib.make_global_mesh(inp["n_model"])
    model = lm_model(None, None, inp["state_dict"])
    mesh_lib.shard_params(model, mesh)
    host = dl.params_to_host(model.state_dict(), mesh_lib.split_dims(model),
                             mesh.model_group)
    grads = [torch.full((3,), float(rank)), torch.full((2,), 2.0 * rank,
                                                       dtype=torch.float64)]
    dl.all_reduce_mean(grads)
    if rank == 1:
        time.sleep(1.5)   # rank 0's clock must win whatever rank 1's says
    return {"gathered": gathered, "t_gathered": t_gathered,
            "host": host, "stamp": dl.agreed_timestamp(),
            "local_stamp": time.time(), "grads": grads,
            "main": dl.is_main_process(), "count": dl.process_count()}


def job_cli(inp, rank):
    """Each of ``inp["runs"]``: a trainer CLI's ``main`` with this rank's
    distributed flags added (the group is joined by the first); records
    the files each rank opens for writing, and per run the digest of the
    trained parameters and, where asked, the full state gathered over
    ``gather``'s model group, or the evaluation's result."""
    import builtins
    from ivideogpt_tpu_torch import train_gpt, train_tokenizer
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    writes, out = [], []
    real_open = builtins.open

    def recording_open(file, mode="r", *args, **kw):
        if any(c in mode for c in "wax+"):
            writes.append(os.path.abspath(str(file)))
        return real_open(file, mode, *args, **kw)
    builtins.open = recording_open
    try:
        for run in inp["runs"]:
            if run.get("chdir"):
                os.chdir(run["chdir"])
            cli = train_gpt if run["cli"] == "gpt" else train_tokenizer
            res = cli.main(run["argv"] + [
                "--coordinator_address", COORD, "--num_processes",
                str(WORLD), "--process_id", str(rank), "--dist_backend",
                "gloo"])
            rec = {}
            if isinstance(res, dict):
                rec["result"] = res
            elif isinstance(res, tuple):
                rec["digest"] = digest([*res[0].params, *res[1].params,
                                        *res[1].model.buffers()])
                rec["step"] = res[2].step
            else:
                rec["digest"] = digest(res.params)
                rec["step"] = res.step
                if "gather" in run:
                    mesh = mesh_lib.make_global_mesh(run["gather"])
                    full = mesh_lib.HostState(res, mesh).state_dict()
                    rec["full"] = {"model": full["model"],
                                   "optimizer": full["optimizer"]}
            out.append(rec)
    finally:
        builtins.open = real_open
    return {"runs": out, "writes": writes}


COORD, WORLD = None, 1


def main():
    global COORD, WORLD
    job, coord, world, rank, out_dir = sys.argv[1:6]
    world, rank = int(world), int(rank)
    COORD, WORLD = coord, world
    torch.manual_seed(0)
    from ivideogpt_tpu_torch.parallel import distributed as dl
    inp_path = os.path.join(out_dir, "inputs.pt")
    inp = (torch.load(inp_path, weights_only=False)
           if os.path.exists(inp_path) else {})
    if not job.startswith("cli"):
        dl.maybe_initialize(coord, world, rank, device="cpu",
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    out = globals()[f"job_{job}"](inp, rank)
    torch.save(out, os.path.join(out_dir, f"out-{rank}.pt"))
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

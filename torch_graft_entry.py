"""Entry points of the PyTorch port (the twin of ``__graft_entry__.py``).

entry()             -> (fn, example_args): the forward (policy) step of
                       the n=4 agent on one device.
dryrun_multichip(n) -> n ranks, one process each, run one full TD
                       train segment on tiny shapes: n=4 (on a
                       (n/2, 2) mesh, the table sharded along the model
                       axis, when n >= 4 is even; else data-parallel),
                       then the canonical n=5 learner and the n=6
                       flagship with every env recorded, data-parallel.

Run as a script it is one rank of that dry run (``dryrun_multichip``
starts it); nothing here imports jax or the JAX package.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

# a rank that waits for a peer that died must not hang its caller
DRYRUN_TIMEOUT = 600


def entry(device=None):
    """Forward step on the n=4 TD agent.

    The forward pass: all-4 afterstate expansion (row-LUT gathers),
    n-tuple feature indices, weight-table gather evaluation, masked
    greedy argmax.  Returns (best_dir, best_val, done) for the batch.
    ``device`` defaults to the card; pass ``"cpu"`` to run without one.
    """
    import torch

    from tpu2048_torch.agent import td
    from tpu2048_torch.draws import TorchDraws
    from tpu2048_torch.engine import core as engine
    from tpu2048_torch.features import ntuple
    from tpu2048_torch.train import card_device

    device = card_device(device, "entry")
    ts = ntuple.get_tuple_set(4)

    def forward(weights, boards):
        chosen, best_dir, best_val, best_delta, done = td.select_greedy(
            ts, weights, boards
        )
        return best_dir, best_val, done

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    weights = ntuple.init_weights(ts, gen)
    boards = engine.new_boards(1024, TorchDraws(gen))
    return forward, (weights, boards)


def _dryrun_rank(rendezvous: str, n_ranks: int, rank: int, device: str) -> None:
    """One rank of the dry run: three sharded train segments."""
    import torch

    from tpu2048_torch.config import AgentConfig, MeshConfig, TrainConfig
    from tpu2048_torch.draws import TorchDraws
    from tpu2048_torch.features import ntuple
    from tpu2048_torch.parallel import distributed
    from tpu2048_torch.parallel import mesh as pmesh

    if device == "cpu":
        torch.set_num_threads(1)
    assert distributed.initialize(rendezvous, n_ranks, rank, device=device)
    m = distributed.global_mesh(MeshConfig(data=n_ranks, model=1))
    # both mesh axes when possible, as the reference's dry run: envs
    # data-parallel and the weight table sharded along the model axis
    if n_ranks >= 4 and n_ranks % 2 == 0:
        m4 = distributed.global_mesh(MeshConfig(data=n_ranks // 2, model=2))
    else:
        m4 = m
    tcfg = TrainConfig(
        num_envs=8 * n_ranks,
        steps_per_call=4,
        ring_size=64,
        record_envs=2,
        max_record_steps=64,
        seed=0,
    )
    # n=4 on ``m4``; envs data-parallel, the table replicated: the shipped
    # geometry (n=5) in canonical-orbit form, its sparse update crossing
    # ranks as index/value all-gathers; and the flagship exactly as
    # shipped: n=6 canonical + temporal coherence, ALL envs recorded
    # (logs held per rank), the 95.7M-entry table and both TC sums
    # replicated, the 16^4 class pair all-reduced
    passes = [(AgentConfig(n=4), tcfg), (AgentConfig(n=5), tcfg),
              (AgentConfig(n=6), dataclasses.replace(tcfg, record_envs=-1))]
    episodes = []
    for seed, (acfg, cfg) in enumerate(passes):
        mesh = m4 if seed == 0 else m
        ts = ntuple.get_tuple_set(acfg.n)
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(seed)
        draws = TorchDraws(gen)
        state = pmesh.init_sharded_td_state(ts, acfg, cfg, mesh, draws)
        seg = pmesh.make_sharded_train_segment(ts, acfg, cfg, mesh, draws)
        out = seg(state)
        # read on the host to prove execution completed
        assert float(out.weights.abs().sum()) > 0.0
        assert int(out.env.odometer.min()) >= 0
        # this rank's share of the envs, and of the table
        assert out.env.score.shape == (cfg.num_envs // mesh.data,)
        shard = mesh.table_shard(ts)
        assert out.weights.shape == (ts.total if shard is None
                                     else shard.size,)
        episodes.append(int(out.metrics.episodes))
        del state, out
    m.barrier()
    torch.distributed.destroy_process_group()
    print(f"DRYRUN_RANK_OK {rank} episodes={episodes} "
          f"collectives={m.counts} n4_collectives={m4.counts}", flush=True)


def dryrun_multichip(n_devices: int) -> None:
    """Run one full sharded train segment per geometry on ``n_devices``
    ranks: NCCL ranks, one per card, when that many cards are present,
    else gloo ranks on the CPU, as the output line says.  The n=4 pass
    takes the reference's variant, a (n/2, 2) mesh with the table
    sharded along the model axis, when ``n_devices >= 4`` is even; the
    others (and n=4 otherwise) put every rank on the data axis, the
    table replicated with all-reduced and all-gathered TD updates."""
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    device = "cuda" if cards >= n_devices else "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = f"file://{tmp}/rendezvous"
        here = os.path.abspath(__file__)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(here))
        procs = [
            subprocess.Popen(
                [sys.executable, here, rendezvous, str(n_devices), str(r),
                 device],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            for r in range(n_devices)
        ]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DRYRUN_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"DRYRUN_RANK_OK {r}" not in out:
            raise RuntimeError(f"dryrun rank {r} failed:\n{out}")
    where = (f"{n_devices} NCCL ranks on {n_devices} cards" if device == "cuda"
             else f"{n_devices} gloo ranks on the CPU ({cards} card(s) "
                  "present)")
    print(
        f"dryrun_multichip OK: {where}, "
        f"{8 * n_devices} envs x 4 steps; n=4 segment "
        + (f"on a ({n_devices // 2}, 2) mesh OK; "
           if n_devices >= 4 and n_devices % 2 == 0 else "OK; ")
        + "canonical n=5 segment OK; flagship n=6 canonical+tc segment OK"
    )


if __name__ == "__main__":
    _dryrun_rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

"""Worker for the port's two-process training tests (spawned by
tests/test_torch_multiprocess_train.py). Joins a gloo process group through
``core.distributed.initialize`` and trains the encoder data parallel across
the two processes, one leg at a time (:data:`LEGS`): contrastive without and
with hard negatives, MLM, data 2 x model 2, an uneven global batch, and a
dropout run made twice; then the raw collectives (``gather_rows`` on uneven
blocks, forward and backward, and ``all_reduce_flat``) and
``save_encoder``.

Each leg writes ``<leg>_<pid>.npz`` into the output directory (per-epoch
losses, the float32 masters by name, the rows of every ``train_forward``
mesh call) and prints ``LEG_OK <leg> proc=<pid>``. The encoder's config and
its starting state dict come from ``cfg.json`` and ``state.npz`` there,
which the parent writes.

Run: python tests/_torch_dist_train_worker.py <process_id> <port> <dir>
"""
import json
import os
import sys

import numpy as np

# name -> (trainer, row shards a process, model axis, hard negatives,
#          pairs or texts, extra encoder config)
LEGS = {
    "contrastive": ("contrastive", 1, 1, False, 8, {}),
    "contrastive_hn": ("contrastive", 2, 1, True, 8, {}),
    "mlm": ("mlm", 1, 1, False, 8, {}),
    "tp": ("contrastive", 1, 2, False, 8, {}),
    "uneven": ("contrastive", 1, 1, False, 7, {}),
    "dropout": ("contrastive", 1, 1, True, 8, {"dropout_rate": 0.25}),
}
CONTRASTIVE = dict(epochs=3, batch_size=8, max_len_query=16,
                   max_len_chunk=32, seed=0, learning_rate=1e-3)
MLM = dict(epochs=3, batch_size=8, max_len=32, learning_rate=1e-3, seed=3)


def leg_data(leg):
    """(pairs, hard negatives or None) of a contrastive leg, the texts of
    an MLM leg; one step an epoch, so each epoch's loss is a step's."""
    kind, _, _, hard, n, _ = LEGS[leg]
    if kind == "mlm":
        return [f"w{i % 7} x{i % 5} y{i % 3} z{i} the corpus"
                for i in range(n)], None
    pairs = [(f"query number {i}", f"chunk body text {i} {i}")
             for i in range(n)]
    negs = [f"unrelated passage {i} of words" for i in range(n)]
    return pairs, (negs if hard else None)


def train(enc, leg):
    """Train ``enc`` on ``leg``'s data; the per-epoch losses."""
    from semanticsearch_tpu_torch.train import encoder_train as tt
    from semanticsearch_tpu_torch.train import mlm_pretrain as tm

    data, negs = leg_data(leg)
    if LEGS[leg][0] == "mlm":
        hist = tm.MLMPretrainer(enc, tm.MLMConfig(**MLM)).fit(data)
    else:
        hist = tt.ContrastiveEncoderTrainer(
            enc, tt.ContrastiveConfig(**CONTRASTIVE)).fit(
                data, hard_negatives=negs)
    return np.array([h["loss"] for h in hist])


def main() -> int:
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    pid, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    import torch

    from semanticsearch_tpu_torch.core import distributed
    from semanticsearch_tpu_torch.core.config import EncoderConfig
    from semanticsearch_tpu_torch.core.mesh import MeshSpec
    from semanticsearch_tpu_torch.models import encoder as tencoder
    from semanticsearch_tpu_torch.train import encoder_train as tt

    assert distributed.initialize(f"127.0.0.1:{port}", 2, pid,
                                  backend="gloo") is True
    with open(os.path.join(out_dir, "cfg.json")) as f:
        cfg = json.load(f)
    state = {k: torch.from_numpy(v)
             for k, v in np.load(os.path.join(out_dir, "state.npz")).items()}
    cpu = torch.device("cpu")

    def save(leg, **arrays):
        np.savez(os.path.join(out_dir, f"{leg}_{pid}.npz"), **arrays)
        print(f"LEG_OK {leg} proc={pid}", flush=True)

    def encoder(leg):
        _, shards, model, _, _, extra = LEGS[leg]
        mesh = distributed.global_mesh(MeshSpec(model=model),
                                       local_devices=[cpu] * (shards * model))
        enc = tencoder.SentenceEncoder(EncoderConfig(**cfg, **extra),
                                       device="cpu", mesh=mesh,
                                       state_dict=state)
        rows = []
        forward = enc._mesh_apply

        def counted(ids, masks, *args, **kw):  # rows this process forwards
            rows.append(sum(int(x.shape[0]) for x in ids))
            return forward(ids, masks, *args, **kw)

        enc._mesh_apply = counted
        return enc, rows

    def masters(enc):
        return {f"p:{k}": v.detach().numpy().copy()
                for k, v in enc.master.state_dict().items()}

    for leg in LEGS:
        if leg == "dropout":
            continue
        enc, rows = encoder(leg)
        losses = train(enc, leg)
        save(leg, losses=losses, rows=np.array(rows), **masters(enc))

    # dropout 0.25, twice from the same start: the first mask each run
    # draws, which must differ between the processes (their rows differ),
    # and the chunk side's first mask, which must not repeat the query
    # side's
    first = []
    keep_mask = tencoder.Dropout.keep_mask

    def recording(self, shape, device):
        keep = keep_mask(self, shape, device)
        first.append(keep.clone())
        return keep

    tencoder.Dropout.keep_mask = recording
    runs = []
    for _ in range(2):
        first.clear()
        enc, rows = encoder("dropout")
        starts, apply = [], enc._mesh_apply

        def marked(*args, _apply=apply, _starts=starts, **kw):
            _starts.append(len(first))  # masks drawn before this call
            return _apply(*args, **kw)

        enc._mesh_apply = marked
        losses = train(enc, "dropout")
        runs.append((losses, masters(enc), first[0], first[starts[1]]))
    tencoder.Dropout.keep_mask = keep_mask
    save("dropout", losses=runs[0][0], losses2=runs[1][0],
         mask=runs[0][2].numpy(), mask2=runs[1][2].numpy(),
         mask_chunk=runs[0][3].numpy(), rows=np.array(rows),
         **runs[0][1], **{"2" + k: v for k, v in runs[1][1].items()})

    # the collectives: an uneven differentiable gather (3 rows, then 2)
    # and one flat bucket summed
    mesh = distributed.global_mesh(MeshSpec())
    x = (torch.arange(3 - pid, dtype=torch.float64)[:, None] * 10 + pid
         + torch.arange(4, dtype=torch.float64)).requires_grad_(True)
    g = distributed.gather_rows(mesh, x, [3, 2])
    weight = torch.arange(5 * 4, dtype=torch.float64).reshape(5, 4)
    (g * weight).sum().backward()
    a = torch.full((2, 3), 1.0 + pid)
    b = torch.full((5,), 10.0 * (pid + 1))
    distributed.all_reduce_flat(mesh, [a, b])
    save("collectives", gathered=g.detach().numpy(), grad=x.grad.numpy(),
         a=a.numpy(), b=b.numpy())

    # save_encoder: the primary process writes, both return after it
    written = []
    save_checkpoint = tt.save_checkpoint

    def counting(*args, **kw):
        written.append(args[0])
        return save_checkpoint(*args, **kw)

    tt.save_checkpoint = counting
    enc, _ = encoder("contrastive")
    path = tt.save_encoder(enc, os.path.join(out_dir, "saved"))
    tt.save_checkpoint = save_checkpoint
    save("save", writes=np.array(len(written)),
         complete=np.array(os.path.exists(os.path.join(path,
                                                       "metadata.json"))))
    print(f"DIST_OK proc={pid}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's training infrastructure on the CPU, mirroring
``tests/test_train_infra.py`` case for case on reduced Qwen3-0.6B (bf16,
as there): the loss falls; a restart equals an unbroken run; microbatches
equal the full batch; the data is deterministic and elastic; the lr
schedule's shape; AdamW's clipping and decay; the global norm; and the
launcher's ``--fail-at`` / ``--retries`` resuming from a checkpoint.
Keep-k, atomicity and the elastic dtype round trip of the checkpoint
manager are in ``tests/test_torch_checkpoint.py``."""
import contextlib
import io

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, _example_tokens, host_batch
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import train_loop
from repro_torch.models import lm
from repro_torch.models.module import tree_leaves
from repro_torch.optim import (OptConfig, adamw_step, global_norm,
                               init_opt_state, lr_schedule)
from repro_torch.train import make_train_step

# one intra-op torch thread: the port's tests run tiny tensors, which many
# threads only slow down, and the suite's workers share the cores
torch.set_num_threads(1)

CFG = get_config("qwen3-0.6b").reduced()
DC = DataConfig(vocab=CFG.vocab, seq_len=32, global_batch=4)


def test_loss_decreases():
    _, _, losses = train_loop(CFG, 8, DC, device="cpu")
    assert losses[-1] < losses[0]


def test_restart_equivalent(tmp_path):
    """6 steps straight == 3, a checkpoint, a restore, 3 more (the same
    optimizer schedule across runs); the restored step counter, moments
    and master copy carry on."""
    optc = OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=6)
    _, _, straight = train_loop(CFG, 6, DC, optc=optc, device="cpu")
    ck = CheckpointManager(str(tmp_path / "ck"))
    train_loop(CFG, 3, DC, ckpt=ck, ckpt_every=3, optc=optc, device="cpu")
    _, opt, resumed = train_loop(CFG, 6, DC, ckpt=ck, optc=optc,
                                 device="cpu")
    np.testing.assert_allclose(straight[3:], resumed, rtol=1e-4, atol=1e-5)
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 6


def test_microbatch_equals_full_batch():
    params = lm.init_params(CFG, 0, device="cpu")
    opt = init_opt_state(params)
    batch = {k: torch.as_tensor(v) for k, v in host_batch(DC, 0).items()}
    optc = OptConfig(peak_lr=1e-3)
    p1, o1, m1 = make_train_step(CFG, optc)(params, opt, batch)
    p2, o2, m2 = make_train_step(CFG, optc, microbatch=2)(params, opt, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    l1 = tree_leaves(o1["master"])[0]
    l2 = tree_leaves(o2["master"])[0]
    # bf16 forward/backward: accumulation-order noise ~1e-5 on the master
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=2e-2,
                               atol=5e-5)


def test_data_determinism_and_elasticity():
    b1 = host_batch(DC, 5)
    b2 = host_batch(DC, 5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = host_batch(DC, 6)
    assert np.any(b1["tokens"] != b3["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    # elastic: per-example determinism regardless of batch slicing
    full = _example_tokens(DC, 5, np.arange(4))
    half = _example_tokens(DC, 5, np.arange(2, 4))
    np.testing.assert_array_equal(full[2:], half)


def test_lr_schedule_shape():
    optc = OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100)
    lrs = [float(lr_schedule(optc, s)) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0 and abs(lrs[2] - 1e-3) < 1e-9
    assert lrs[3] < lrs[2] and lrs[4] <= lrs[3]
    assert lrs[4] >= optc.peak_lr * optc.end_lr_frac - 1e-9


def test_adamw_clip_and_decay():
    params = {"w": torch.ones(4)}
    opt = init_opt_state(params)
    grads = {"w": torch.full((4,), 100.0)}   # huge -> clipped
    optc = OptConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=10,
                     clip_norm=1.0, weight_decay=0.0)
    p2, o2, mets = adamw_step(grads, opt, optc, params)
    assert float(mets["grad_norm"]) == pytest.approx(200.0)
    assert torch.all(p2["w"] < 1.0)          # moved against gradient
    assert torch.all(torch.isfinite(o2["m"]["w"]))


def test_global_norm():
    t = {"a": torch.ones(3), "b": torch.ones(4)}
    assert float(global_norm(t)) == pytest.approx(np.sqrt(7.0))


def test_train_cli_resumes_after_an_injected_failure(tmp_path):
    """``main`` with ``--fail-at 3 --retries 1``: the first attempt saves
    step 2 and fails at step 3; the retry resumes from step 2 and
    finishes.  A mesh backend other than gloo or nccl is refused."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(["--reduced", "--device", "cpu", "--steps", "4",
                             "--batch", "2", "--seq", "16", "--ckpt-dir",
                             str(tmp_path), "--ckpt-every", "2",
                             "--fail-at", "3", "--retries", "1"])
    text = out.getvalue()
    assert rc == 0, text
    assert "FAILURE (injected failure at step 3); restarting" in text
    assert "[train] resumed from step 2" in text
    assert "[train] done" in text
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        train_cli.main(["--reduced", "--device", "cpu", "--data", "2",
                        "--backend", "mpi"])

"""Checkpointing, resume, graceful stop and the train -> export -> sample
loop of the port, on the CPU with a toy CondUNet and synthetic data."""

import json
import os

import numpy as np
import pytest
import torch

from superdiff_torch import config as tcfg
from superdiff_torch.checkpoint import CheckpointManager, load_checkpoint_file
from superdiff_torch.cli import export as export_cli
from superdiff_torch.cli import sample as sample_cli
from superdiff_torch.cli import train as train_cli
from superdiff_torch.compat import flax_params as fp
from superdiff_torch.diffusion import make_schedule
from superdiff_torch.inference import load_run
from superdiff_torch.models.presets import model_from_config
from superdiff_torch.training.loop import train
from superdiff_torch.training.state import create_train_state, make_optimizer
from superdiff_torch.training.steps import make_train_step

torch.set_num_threads(1)


def _cfg(base, run_id="r", epochs=2, **training):
    cfg = tcfg.Config()
    cfg.run_id = run_id
    cfg.model.preset = "small64"
    cfg.model.base_channels = 8
    cfg.model.compute_dtype = cfg.model.norm_dtype = "float32"
    cfg.model.dropout = 0.1            # resume must replay the dropout draws
    t = cfg.training
    t.resolution, t.batch_size, t.num_timesteps = 16, 4, 8
    t.num_epochs, t.steps_per_epoch = epochs, 2
    t.vis_every, t.eval_batches = 0, 1
    for k, v in training.items():
        setattr(t, k, v)
    cfg.logging.stdout = False
    cfg.paths.local_base = cfg.paths.cluster_base = str(base)
    return cfg


def _run_dir(base, run_id="r"):
    return os.path.join(str(base), "outputs", "PNEUMONIA",
                        f"experiment_exp0_run_{run_id}")


def _state(seed=0):
    cfg = _cfg("unused")
    model = model_from_config(cfg, device="cpu").init_parameters(seed)
    return create_train_state(model, torch.Generator().manual_seed(seed),
                              tx=make_optimizer(learning_rate=1e-2))


def _assert_same_checkpoint(a, b):
    assert a["step"] == b["step"]
    assert a["opt_state"]["count"] == b["opt_state"]["count"]
    assert set(a["rng"]) == {"generator", "global"}
    assert all(torch.equal(a["rng"][k], b["rng"][k]) for k in a["rng"])
    for part in ("params", "ema_params"):
        assert list(a[part]) == list(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for part in ("mu", "nu"):
        for x, y in zip(a["opt_state"][part], b["opt_state"][part]):
            assert torch.equal(x, y)


def test_save_restore_round_trip_and_keep_last_n(tmp_path):
    st = _state()
    step_fn = make_train_step(make_schedule(8, device="cpu"),
                              conditional=True, cfg_drop_prob=0.1,
                              null_label=2)
    batch = {"image": torch.randn(4, 16, 16, 1),
             "label": torch.tensor([0, 1, 1, 0])}
    mngr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mngr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mngr.restore(st)
    for _ in range(3):
        st, _ = step_fn(st, batch)
        assert mngr.save(st) is True
    assert mngr.save(st, force=True) is False       # that step is saved
    assert mngr.all_steps() == [2, 3] and mngr.latest_step() == 3
    assert not mngr.saving_in_progress()
    assert not [d for d in os.listdir(mngr.directory) if d.startswith(".")]
    saved = load_checkpoint_file(mngr.directory, 3)
    assert set(saved) == {"step", "params", "ema_params", "opt_state", "rng"}

    fresh = _state(seed=1)
    assert not torch.equal(fresh.params[0], st.params[0])
    fresh = mngr.restore(fresh)
    assert fresh.step == 3 and fresh.opt_state["count"] == 3
    assert torch.equal(fresh.generator.get_state(), st.generator.get_state())
    for a, b in zip(fresh.params + fresh.ema_params + fresh.opt_state["mu"]
                    + fresh.opt_state["nu"],
                    st.params + st.ema_params + st.opt_state["mu"]
                    + st.opt_state["nu"]):
        assert torch.equal(a, b)
    # the next step of the restored state is the next step of the original
    # (restoring again rewinds the default generator that dropout draws from)
    st, m1 = step_fn(st, batch)
    fresh = mngr.restore(fresh)
    fresh, m2 = step_fn(fresh, batch)
    assert m1["loss"].item() == m2["loss"].item()
    assert all(torch.equal(a, b) for a, b in zip(st.params, fresh.params))
    older = mngr.restore(_state(seed=2), step=2)
    assert older.step == 2
    mngr.wait()
    mngr.close()


def test_resume_equals_straight_run_bit_for_bit(tmp_path):
    """2 + 2 steps with a resume in between against 4 straight steps: every
    saved tensor, the generator state and the counters are identical."""
    s1 = train(_cfg(tmp_path, "straight", epochs=2), use_synthetic=True,
               device="cpu")
    assert s1["steps"] == 4 and s1["stopped_early"] == 0.0
    first = train(_cfg(tmp_path, "resumed", epochs=1), use_synthetic=True,
                  device="cpu")
    assert first["steps"] == 2
    s2 = train(_cfg(tmp_path, "resumed", epochs=2), use_synthetic=True,
               device="cpu")
    assert s2["steps"] == 4
    a = load_checkpoint_file(
        os.path.join(_run_dir(tmp_path, "straight"), "checkpoints"), 4)
    b = load_checkpoint_file(
        os.path.join(_run_dir(tmp_path, "resumed"), "checkpoints"), 4)
    _assert_same_checkpoint(a, b)
    assert s1["final_loss"] == s2["final_loss"]
    # EMA is its own copy and lags the parameters
    assert any(not torch.equal(v, a["ema_params"][k])
               for k, v in a["params"].items())
    # resume=False starts over instead
    s3 = train(_cfg(tmp_path, "resumed", epochs=1), use_synthetic=True,
               resume=False, device="cpu")
    assert s3["steps"] == 2


def test_graceful_stop_writes_a_checkpoint(tmp_path):
    calls = {"n": 0}

    def should_stop():
        calls["n"] += 1
        return calls["n"] >= 3

    summary = train(_cfg(tmp_path, "stop", epochs=5), use_synthetic=True,
                    should_stop=should_stop, device="cpu")
    assert summary["stopped_early"] == 1.0 and summary["steps"] == 3
    ck = CheckpointManager(os.path.join(_run_dir(tmp_path, "stop"),
                                        "checkpoints"))
    assert ck.latest_step() == 3
    for key in ("final_loss", "mean_last_epoch_loss"):
        assert np.isfinite(summary[key])
    # a restart picks the run up at the start of the interrupted epoch
    # (start_epoch = step // steps_per_epoch, as in the reference) and runs
    # that epoch's 2 batches
    again = train(_cfg(tmp_path, "stop", epochs=2), use_synthetic=True,
                  device="cpu")
    assert again["steps"] == 5 and again["stopped_early"] == 0.0


def test_loop_outputs_metrics_best_val_and_plots(tmp_path):
    cfg = _cfg(tmp_path, "full", epochs=2, vis_every=2, keep_checkpoints=1)
    summary = train(cfg, use_synthetic=True, device="cpu")
    assert set(summary) == {"final_loss", "mean_last_epoch_loss",
                            "best_val_loss", "best_val_step", "steps",
                            "stopped_early"}
    run = _run_dir(tmp_path, "full")
    files = set(os.listdir(run))
    assert {"config.yaml", "metrics.jsonl", "training.log", "best_val.json",
            "loss_curve.png", "samples_epoch2.png", "checkpoints",
            "checkpoints_best"} <= files
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "avg_loss" in r]
    val_rows = [r for r in rows if "val_loss" in r]
    assert [r["step"] for r in train_rows] == [2, 4] and len(val_rows) == 2
    assert all(np.isfinite(r["grad_norm"]) and r["images_per_sec"] > 0
               for r in train_rows)
    # no card, so no graph: every train step ran its body eagerly
    assert [r["graph_replay_share"] for r in train_rows] == [0.0, 0.0]
    with open(os.path.join(run, "best_val.json")) as f:
        best = json.load(f)
    assert best["step"] == int(summary["best_val_step"])
    assert best["val_loss"] == min(r["val_loss"] for r in val_rows)
    assert CheckpointManager(os.path.join(run, "checkpoints"),
                             max_to_keep=1).all_steps() == [4]
    # vis_every=0 draws nothing (matplotlib is then never imported);
    # logging.profile_steps traces steps of the first epoch
    quiet = _cfg(tmp_path, "noplots", epochs=1, steps_per_epoch=3)
    quiet.logging.profile_steps = 1
    train(quiet, use_synthetic=True, device="cpu")
    assert not [f for f in os.listdir(_run_dir(tmp_path, "noplots"))
                if f.endswith(".png")]
    trace = os.path.join(_run_dir(tmp_path, "noplots"), "profile",
                         "trace.json")
    assert os.path.getsize(trace) > 0
    with open(trace) as f:                 # the traced step's spans
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.step", "train.forward", "train.backward",
            "train.optimizer", "train.ema"} <= names


def test_run_paths_do_not_depend_on_the_host_name(tmp_path, monkeypatch):
    """Only ``IS_CLUSTER=1`` selects ``paths.cluster_base``; a host called
    like a cluster node still writes under ``paths.local_base``."""
    import socket

    from superdiff_torch.utils.env import is_cluster, resolve_paths

    cfg = _cfg(tmp_path / "local", "p")
    cfg.paths.cluster_base = str(tmp_path / "cluster")
    monkeypatch.delenv("IS_CLUSTER", raising=False)
    monkeypatch.setattr(socket, "gethostname", lambda: "gpu-node-3")
    assert not is_cluster()
    paths = resolve_paths(cfg)
    assert paths.base == str(tmp_path / "local")
    assert paths.output_dir == _run_dir(tmp_path / "local", "p")
    assert paths.checkpoint_dir == os.path.join(paths.output_dir,
                                                "checkpoints")
    monkeypatch.setenv("IS_CLUSTER", "1")
    assert is_cluster()
    assert resolve_paths(cfg).base == str(tmp_path / "cluster")


def test_train_refuses_what_is_not_there(tmp_path):
    # without --synthetic the loop reads a dataset tree: a missing one
    # fails at start-up, before any model is built
    with pytest.raises(FileNotFoundError, match="dataset directory not found"):
        train(_cfg(tmp_path), use_synthetic=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(_cfg(tmp_path), use_synthetic=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--synthetic", "--set",
                            f"paths.local_base={tmp_path}", "--set",
                            f"paths.cluster_base={tmp_path}"])


def test_load_run_export_and_sample_from_a_trained_run(tmp_path, capsys):
    """``load_run`` reads the port's checkpoints (latest, ``step=``,
    ``best=``) and loads the EMA copy; ``cli.export`` writes the npz that
    ``cli.sample`` then samples from."""
    rc = train_cli.main([
        "--synthetic", "--device", "cpu", "--run-id", "cli",
        "--set", "model.preset=small64", "--set", "model.base_channels=8",
        "--set", "model.compute_dtype=float32",
        "--set", "training.resolution=16", "--set", "training.batch_size=4",
        "--set", "training.num_timesteps=8", "--set", "training.num_epochs=2",
        "--set", "training.steps_per_epoch=2", "--set", "training.vis_every=0",
        "--set", "training.eval_batches=1", "--set", "logging.stdout=false",
        "--set", f"paths.local_base={tmp_path}",
        "--set", f"paths.cluster_base={tmp_path}"])
    assert rc == 0 and "'steps': 4" in capsys.readouterr().out
    run = _run_dir(tmp_path, "cli")
    ck = os.path.join(run, "checkpoints")
    assert CheckpointManager(ck).all_steps() == [2, 4]
    cfg, model, schedule = load_run(run, device="cpu")
    assert not model.training and schedule.num_timesteps == 8
    latest = load_checkpoint_file(ck, 4)
    for k, v in model.state_dict().items():
        assert torch.equal(v, latest["ema_params"][k])
    assert any(not torch.equal(v, latest["params"][k])
               for k, v in model.state_dict().items())
    _, at2, _ = load_run(run, device="cpu", step=2)
    two = load_checkpoint_file(ck, 2)
    assert all(torch.equal(v, two["ema_params"][k])
               for k, v in at2.state_dict().items())
    with open(os.path.join(run, "best_val.json")) as f:
        best_step = json.load(f)["step"]
    _, best, _ = load_run(run, device="cpu", best=True)
    tagged = load_checkpoint_file(ck + "_best", best_step)
    assert all(torch.equal(v, tagged["ema_params"][k])
               for k, v in best.state_dict().items())
    with pytest.raises(FileNotFoundError, match="step 3"):
        load_run(run, device="cpu", step=3)

    out = str(tmp_path / "exported")
    if not torch.cuda.is_available():      # the card is the default here too
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_cli.main(["--run-dir", run, "--out", out])
    assert export_cli.main(["--run-dir", run, "--out", out,
                            "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["config.yaml", fp.EXPORT_FILE]
    with np.load(os.path.join(out, fp.EXPORT_FILE)) as z:  # Flax variables
        assert z.files and all(k.startswith("params/") for k in z.files)
    with pytest.raises(ValueError, match="one snapshot"):
        load_run(out, device="cpu", step=2)
    with pytest.raises(FileNotFoundError, match="best-val"):
        load_run(out, device="cpu", best=True)
    _, exported, _ = load_run(out, device="cpu")
    for k, v in exported.state_dict().items():
        assert torch.equal(v, latest["ema_params"][k]), k
    samples = str(tmp_path / "samples")
    assert sample_cli.main(["--run-dir", out, "--method", "ddim",
                            "--num-steps", "4", "--batch-size", "2",
                            "--label", "1", "--device", "cpu",
                            "--out", samples]) == 0
    x = np.load(os.path.join(samples, "samples.npy"))
    assert x.shape == (2, 16, 16, 1) and np.isfinite(x).all()
    # a run dir with neither an export nor a port checkpoint keeps raising
    empty = tmp_path / "orbax_only"
    (empty / "checkpoints" / "10").mkdir(parents=True)
    tcfg.save_config(cfg, str(empty / "config.yaml"))
    with pytest.raises(NotImplementedError, match="Orbax"):
        load_run(str(empty), device="cpu")

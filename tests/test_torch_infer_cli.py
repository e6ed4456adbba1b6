"""``python -m sddm_tpu_torch.infer`` against the root ``infer.py`` on the
CPU, on a tiny JAX checkpoint (NS 72, inner 8, 4 groups, mults 1-2, T=3)
and three short WAV pairs, served in two batches of two files.

The two CLIs draw their sampler noise from different generators, so their
outputs are compared in kind (the same files, names and lengths; target and
condition byte for byte), and the port's outputs are held to the port's own
``SDDM.infer`` on the same rows, each batch at its own row count, with a
generator seeded 0, which shows that batching and regrouping add
nothing.  The samplers
themselves are compared elementwise under one shared noise stream at the
sampler tests' tolerance, rtol 1e-4 and atol 1e-4 (test_torch_enhance.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import infer as jax_infer
from sddm_tpu.cli import build_arch as jax_build_arch
from sddm_tpu.cli import build_diffusion as jax_build_diffusion
from sddm_tpu.cli import build_network as jax_build_network
from sddm_tpu.data.wav_io import save_wav as jax_save_wav
from sddm_tpu.train.checkpoints import save_checkpoint
from sddm_tpu.utils import ConfigParser as JaxConfigParser
from sddm_tpu_torch import infer as tinfer
from sddm_tpu_torch.data import InferDataLoader, InferDataset
from sddm_tpu_torch.models import PackedUNetModified2, UNetModified2
from sddm_tpu_torch.utils import ConfigParser

NS = 72
LENGTHS = {"a": 150, "b": NS, "c": 300}  # 3, 1 and 5 rows: batches of 4 and 5 rows
SAMPLER_TOL = dict(rtol=1e-4, atol=1e-4)


def _config(tmp, name, data_root, packed=False):
    cfg = {
        "name": name,
        "sample_rate": 16000,
        "num_samples": NS,
        "arch": {"type": "SDDM", "args": {"p_transition": "condition_in"}},
        "diffusion": {"type": "GaussianDiffusion",
                      "args": {"schedule": "linear", "n_timestep": 3, "linear_start": 1e-4,
                               "linear_end": 0.05}},
        "network": {"type": "UNetModified2",
                    "args": {"in_channel": 2, "out_channel": 1, "inner_channel": 8,
                             "norm_groups": 4, "channel_mults": [1, 2], "res_blocks": 1,
                             "dropout": 0, "segment_len": 16, "segment_stride": 8}},
        "infer_dataset": {"type": "InferDataset",
                          "args": {"data_root": str(data_root), "datatype": ".wav"}},
        "data_loader": {"type": "AudioDataLoader", "args": {"batch_size": 4}},
        "infer_data_loader": {"type": "InferDataLoader", "args": {"batch_size": 2,
                                                                  "num_workers": 2}},
        "loss": "l1_loss",
        "metrics": ["sisnr"],
        "trainer": {"save_dir": str(tmp / "saved"), "verbosity": 2},
    }
    if packed:
        cfg["packed"] = True
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(root, data dir, checkpoint path, jax params); the checkpoint's run dir
    holds the plain config as ``config.json``."""
    root = tmp_path_factory.mktemp("infer_cli")
    data = root / "data"
    rng = np.random.default_rng(0)
    for name, n in LENGTHS.items():
        t = np.arange(n) / 16000.0
        clean = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        noisy = clean + 0.05 * rng.standard_normal(n).astype(np.float32)
        jax_save_wav(data / "clean" / f"{name}.wav", clean, 16000)
        jax_save_wav(data / "noisy" / f"{name}.wav", noisy, 16000)
    cfg = _config(root, "tiny", data)
    model = jax_build_arch(cfg, jax_build_diffusion(cfg), jax_build_network(cfg, num_samples=NS))
    params = jax.tree_util.tree_map(np.asarray,
                                    model.init(jax.random.PRNGKey(0), (1, 1, NS)))
    run = root / "run"
    run.mkdir()
    (run / "config.json").write_text(json.dumps(cfg))
    ckpt = run / "model_best.ckpt"
    save_checkpoint(ckpt, arch="SDDM", epoch=1, params=params, opt_state={}, monitor_best=0.0,
                    config=cfg)
    return root, data, ckpt, params


def _port_config(setup, run_id, packed=False, **overrides):
    root, data, ckpt, _ = setup
    cfg = {**_config(root, "tiny", data, packed), **overrides}
    return ConfigParser(cfg, resume=ckpt, run_id=run_id, device="cpu")


def _samples(run_dir, kind):
    return {p.name: wavfile.read(p) for p in sorted((run_dir / "samples" / kind).glob("*.wav"))}


@pytest.fixture(scope="module")
def jax_run(setup):
    """The root infer.py with --continuous, on the CPU."""
    root, data, ckpt, _ = setup
    config = JaxConfigParser(_config(root, "tiny", data), resume=ckpt, run_id="jax")
    jax_infer.main(config, continuous=True)
    return config.save_dir


@pytest.fixture(scope="module")
def port_run(setup):
    config = _port_config(setup, "port")
    result = tinfer.main(config)
    return config.save_dir, result


def _expected_outputs(setup, config, seed=0):
    """The port's own sampler over the same rows, batch by batch at each
    batch's own row count, with one generator seeded ``seed``: {file name:
    int16 PCM as save_wav writes}."""
    model = tinfer.build_model(config, torch.device("cpu"))
    loader = InferDataLoader(InferDataset(setup[1], ".wav", 16000, NS), batch_size=2)
    generator = torch.Generator().manual_seed(seed)
    out = {}
    for _t, cond, idx in loader:
        y = model.infer(torch.from_numpy(cond), generator).numpy()
        for f in np.unique(idx):
            wav = y[idx == f].reshape(-1)
            out[f"{loader.dataset.get_name(int(f))}.wav"] = (
                np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    return out


def test_same_files_names_and_lengths_as_jax(jax_run, port_run):
    port_dir, _ = port_run
    for kind in ("output", "target", "condition"):
        want, got = _samples(jax_run, kind), _samples(port_dir, kind)
        assert list(got) == list(want) == [f"{n}.wav" for n in sorted(LENGTHS)]
        for name in want:
            assert got[name][0] == want[name][0] == 16000
            assert got[name][1].shape == want[name][1].shape
            n = LENGTHS[name[:-4]]
            assert got[name][1].shape == (-(-n // NS) * NS,)  # padded to whole rows
    for kind in ("target", "condition"):
        for name in LENGTHS:
            a = (jax_run / "samples" / kind / f"{name}.wav").read_bytes()
            b = (port_dir / "samples" / kind / f"{name}.wav").read_bytes()
            assert a == b


def test_outputs_are_the_samplers_on_the_same_rows(setup, port_run):
    port_dir, result = port_run
    want = _expected_outputs(setup, _port_config(setup, "unused_a"))
    got = _samples(port_dir, "output")
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name][1], want[name])
    # evaluate ran over the samples dir: pesq_wb falls back to its approximation here
    assert set(result) >= {"sisnr", "stoi"} and any(k.startswith("pesq_wb") for k in result)
    for m in result:
        assert (port_dir / "samples" / f"output_{m}.npy").exists()


def test_continuous_writes_jaxs_intermediate_files(setup, jax_run):
    config = _port_config(setup, "port_continuous")
    tinfer.main(config, continuous=True)
    names = sorted(p.name for p in (config.save_dir / "samples" / "intermediate").glob("*.wav"))
    want = sorted(p.name for p in (jax_run / "samples" / "intermediate").glob("*.wav"))
    assert names == want == sorted(f"{n}_t{s:04d}.wav" for n in LENGTHS for s in (1, 2, 3))
    # the trajectory draws what the plain sampler draws: the same outputs
    got = _samples(config.save_dir, "output")
    for name, pcm in _expected_outputs(setup, config).items():
        np.testing.assert_array_equal(got[name][1], pcm)


def test_trajectory_matches_jax_under_shared_noise(setup):
    root, data, ckpt, params = setup
    cfg = _config(root, "tiny", data)
    jmodel = jax_build_arch(cfg, jax_build_diffusion(cfg), jax_build_network(cfg, num_samples=NS))
    tmodel = tinfer.build_model(_port_config(setup, "unused_b"), torch.device("cpu"))
    assert tmodel.sample_interval() == jmodel.sample_interval() == 1
    rng = np.random.default_rng(5)
    cond = rng.uniform(-0.5, 0.5, (2, 1, NS)).astype(np.float32)
    xT = rng.standard_normal(cond.shape).astype(np.float32)
    step_noises = rng.standard_normal((3,) + cond.shape).astype(np.float32)
    want_x0, want_traj = jmodel.infer(params, jax.random.PRNGKey(0), jnp.asarray(cond),
                                      return_trajectory=True,
                                      noise_stream=(jnp.asarray(xT), jnp.asarray(step_noises)))
    x0, traj = tmodel.infer(torch.from_numpy(cond),
                            noise_stream=(torch.from_numpy(xT), torch.from_numpy(step_noises)),
                            return_trajectory=True)
    assert traj.shape == (3, 2, 1, NS) == np.asarray(want_traj).shape
    np.testing.assert_allclose(traj.numpy(), np.asarray(want_traj), **SAMPLER_TOL)
    np.testing.assert_allclose(x0.numpy(), np.asarray(want_x0), **SAMPLER_TOL)
    assert torch.equal(traj[-1], x0)


def test_ddim_eta_and_steps_compose_in_jaxs_order(setup, tmp_path):
    root, data, ckpt, params = setup
    cfg = _config(root, "tiny", data)
    jmodel = jax_build_arch(cfg, jax_build_diffusion(cfg), jax_build_network(cfg, num_samples=NS))
    jmodel = jmodel.with_ddim(0.5).with_sampling_steps(2)
    tmodel = tinfer.build_model(_port_config(setup, "unused_c"), torch.device("cpu"),
                                num_steps=2, ddim_eta=0.5)
    assert tmodel.num_timesteps == jmodel.num_timesteps == 2
    assert (tmodel.p_transition, tmodel.ddim_eta) == ("ddim", 0.5)
    rng = np.random.default_rng(6)
    cond = rng.uniform(-0.5, 0.5, (2, 1, NS)).astype(np.float32)
    xT = rng.standard_normal(cond.shape).astype(np.float32)
    step_noises = rng.standard_normal((2,) + cond.shape).astype(np.float32)
    want = jmodel.infer(params, jax.random.PRNGKey(0), jnp.asarray(cond),
                        noise_stream=(jnp.asarray(xT), jnp.asarray(step_noises)))
    got = tmodel.infer(torch.from_numpy(cond),
                       noise_stream=(torch.from_numpy(xT), torch.from_numpy(step_noises)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAMPLER_TOL)

    # the command line: -r alone reads the run dir's config, -c overlays it
    overlay = tmp_path / "overlay.json"
    overlay.write_text(json.dumps({"name": "tiny_ddim",
                                   "trainer": {"save_dir": str(tmp_path / "saved")}}))
    result = tinfer.run(["-r", str(ckpt), "-c", str(overlay), "-d", "cpu", "--ddim", "0.5",
                         "--steps", "2"])
    run_dir = next((tmp_path / "saved" / "tiny_ddim").iterdir())
    got = _samples(run_dir, "output")
    config = ConfigParser({**cfg, "name": "unused"}, resume=ckpt, run_id="d", make_dirs=False,
                          device="cpu")
    model = tinfer.build_model(config, torch.device("cpu"), num_steps=2, ddim_eta=0.5)
    loader = InferDataLoader(InferDataset(data, ".wav", 16000, NS), batch_size=2)
    generator = torch.Generator().manual_seed(0)
    for _t, c, idx in loader:
        y = model.infer(torch.from_numpy(c), generator).numpy()
        for f in np.unique(idx):
            pcm = (np.clip(y[idx == f].reshape(-1), -1, 1) * 32767.0).astype(np.int16)
            np.testing.assert_array_equal(got[f"{loader.dataset.get_name(int(f))}.wav"][1], pcm)
    assert "sisnr" in result


def test_packed_and_plain_configs_both_run(setup):
    plain = _port_config(setup, "unused_d")
    packed = _port_config(setup, "port_packed", packed=True)
    assert type(tinfer.build_model(plain, torch.device("cpu")).network) is UNetModified2
    assert isinstance(tinfer.build_model(packed, torch.device("cpu")).network,
                      PackedUNetModified2)
    tinfer.main(packed)
    got = _samples(packed.save_dir, "output")
    want = _expected_outputs(setup, packed)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name][1], want[name])
    # one function in two layouts: the packed outputs within the sampler
    # tolerance of the plain ones (plus one PCM16 step for the rounding)
    for name, pcm in _expected_outputs(setup, plain).items():
        np.testing.assert_allclose(got[name][1] / 32767.0, pcm / 32767.0, rtol=0,
                                   atol=SAMPLER_TOL["atol"] + 1 / 32767.0)


def test_without_a_card_and_without_cpu_it_raises(setup, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for i, extra in enumerate(([], ["-d", "0"])):  # a bare GPU index selects no device
        overlay = tmp_path / f"overlay{i}.json"
        overlay.write_text(json.dumps({"name": f"nocard{i}",
                                       "trainer": {"save_dir": str(tmp_path / "saved")}}))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tinfer.run(["-r", str(setup[2]), "-c", str(overlay)] + extra)


def test_logwav_data_is_written_uncompanded_as_jax_writes_it(setup, tmp_path):
    """``.logwav.npy`` rows are log-modulus companded: every written WAV is
    the inverse companding of its rows, byte for byte what JAX's inverse and
    WAV writer give for target and condition."""
    from sddm_tpu.ops.logaudio import log_modulus_normalize_reverse as jax_reverse

    rng = np.random.default_rng(8)
    data = tmp_path / "logwav"
    for side in ("clean", "noisy"):
        (data / side).mkdir(parents=True)
    arrays = {}
    for name, n in (("x", 100), ("y", 160)):
        pair = rng.uniform(-0.6, 0.6, (2, 1, n)).astype(np.float32)
        np.save(data / "clean" / f"{name}.logwav.npy", pair[0])
        np.save(data / "noisy" / f"{name}.logwav.npy", pair[1])
        arrays[name] = pair
    config = _port_config(setup, "port_logwav")
    config.config["infer_dataset"]["args"].update(data_root=str(data), datatype=".logwav.npy")
    tinfer.main(config)
    for name, (clean, noisy) in arrays.items():
        for kind, x in (("target", clean), ("condition", noisy)):
            padded = np.zeros((1, -(-x.shape[-1] // NS) * NS), np.float32)
            padded[:, : x.shape[-1]] = x
            jax_save_wav(tmp_path / "want" / f"{name}.wav",
                         np.asarray(jax_reverse(jnp.asarray(padded), 3)), 16000)
            assert ((config.save_dir / "samples" / kind / f"{name}.wav").read_bytes()
                    == (tmp_path / "want" / f"{name}.wav").read_bytes())
        assert (config.save_dir / "samples" / "output" / f"{name}.wav").exists()

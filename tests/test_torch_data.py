"""The port's data modules against the JAX package's (``sddm_tpu/data``), on
the same files: the WAV codec (arrays equal), every dataset through its
loader (every batch of two epochs equal, ``validation_split`` and its
held-out loader included, ``num_workers`` 0; 2 where nothing is drawn; the
port's random-crop loaders at 2 and 4 workers against JAX's at 0), the
WaveGrad collate at a seed (equal), and the synthetic corpus
generator (the WAV files byte for byte), at versions 1 and 2 and splits
``test`` and ``test_hard``.  The corpus CLI writes the test split with
``seed + 1``, as the root script does."""

import numpy as np
import pytest
from scipy.io import wavfile

from sddm_tpu import data as jdata
from sddm_tpu.data import loaders as jloaders
from sddm_tpu.data.synth import generate_corpus as jax_generate_corpus
from sddm_tpu_torch import data as tdata
from sddm_tpu_torch import make_synthetic_corpus
from sddm_tpu_torch.data import loaders as tloaders
from sddm_tpu_torch.data.synth import generate_corpus


@pytest.fixture(scope="module")
def wav_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    for i in range(7):
        n = 4000 + i * 500
        clean = rng.uniform(-0.5, 0.5, n).astype(np.float32)
        noisy = clean + rng.uniform(-0.1, 0.1, n).astype(np.float32)
        jdata.save_wav(root / "clean" / f"p{i}.wav", clean, 16000)
        jdata.save_wav(root / "noisy" / f"p{i}.wav", noisy, 16000)
        # the vocoder records: |STFT|-like frames next to the noisy side
        np.save(root / "noisy" / f"p{i}.wav.spec.npy",
                rng.rand(33, n // 64).astype(np.float32))
    return root


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["int16", "int32", "float32", "stereo_int16"])
def test_load_wav_equals_jax(kind, tmp_path):
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.9, 0.9, 1000)
    data = {"int16": (x * 32767).astype(np.int16),
            "int32": (x * 2**31 * 0.99).astype(np.int32),
            "float32": x.astype(np.float32),
            "stereo_int16": (np.stack([x, -x], 1) * 32767).astype(np.int16)}[kind]
    path = tmp_path / "a.wav"
    wavfile.write(path, 16000, data)
    got, sr = tdata.load_wav(path)
    want, jsr = jdata.load_wav(path)
    assert sr == jsr == 16000 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1000,), (1, 1000), (1000, 1), (2, 1000)])
def test_save_wav_writes_jaxs_bytes(shape, tmp_path):
    x = np.random.default_rng(4).uniform(-1.2, 1.2, shape).astype(np.float32)
    tdata.save_wav(tmp_path / "t" / "a.wav", x, 16000)
    jdata.save_wav(tmp_path / "j" / "a.wav", x, 16000)
    assert (tmp_path / "t" / "a.wav").read_bytes() == (tmp_path / "j" / "a.wav").read_bytes()


def test_ram_cache_reader_equals_jax(wav_root):
    from sddm_tpu.data.wav_io import load_wav_i16 as jax_i16
    from sddm_tpu_torch.data.wav_io import load_wav_i16

    got, want = load_wav_i16(wav_root / "clean" / "p1.wav"), jax_i16(wav_root / "clean" / "p1.wav")
    assert got[1] == want[1] and got[0].dtype == np.int16
    np.testing.assert_array_equal(got[0], want[0])


# (dataset, datatype, dataset args, loader, loader args)
LOADERS = {
    "audio_crop_shuffled": ("AudioDataset", ".wav", dict(T=1024, seed=3), "AudioDataLoader",
                            dict(batch_size=2, shuffle=True)),
    # T over the longest file (7000 samples): every item padded, nothing drawn
    "audio_pad_ordered": ("AudioDataset", ".wav", dict(T=8000), "AudioDataLoader",
                          dict(batch_size=3, shuffle=False)),
    "audio_ram_cache_split": ("AudioDataset", ".wav", dict(T=1024, seed=1, cache="ram"),
                              "AudioDataLoader", dict(batch_size=2, validation_split=2)),
    "audio_fraction_split": ("AudioDataset", ".wav", dict(T=2048, seed=2), "AudioDataLoader",
                             dict(batch_size=2, validation_split=0.3, drop_last=True)),
    "infer": ("InferDataset", ".wav", dict(T=1500), "InferDataLoader", dict(batch_size=2)),
    "wavegrad_crop": ("NumpyDataset", ".spec.npy", {}, "WaveGradDataLoader",
                      dict(batch_size=3, hop_samples=64, crop_mel_frames=62)),
}
# the loaders that draw random crops
RANDOM_CROPS = ["audio_crop_shuffled", "audio_ram_cache_split", "audio_fraction_split",
                "wavegrad_crop"]


@pytest.mark.parametrize("case,workers", [(c, 0) for c in sorted(LOADERS)]
                         + [("audio_pad_ordered", 2), ("infer", 2)]
                         + [(c, w) for c in RANDOM_CROPS for w in (2, 4)])
def test_loader_batches_equal_jax(case, workers, wav_root):
    """The port's loader at ``workers`` against the JAX package's.  The port
    draws its random crops in batch order whatever the worker count, while
    the JAX package's worker threads draw from the dataset's one generator in
    their own order; so a loader that draws crops is held against JAX's at 0
    workers, the others against JAX's at the same count."""
    ds_name, datatype, ds_args, loader, loader_args = LOADERS[case]
    out = []
    for mod, n_workers in ((tloaders, workers),
                           (jloaders, 0 if case in RANDOM_CROPS else workers)):
        ds = mod.DATASETS[ds_name](wav_root, datatype, sample_rate=16000, **ds_args)
        dl = mod.DATA_LOADERS[loader](ds, num_workers=n_workers, **loader_args)
        epochs = [list(dl), list(dl)]  # two epochs: the per-epoch reshuffle and crops
        val = dl.split_validation()
        if val is not None:
            epochs.append(list(val))
        out.append(epochs)
    assert len(out[0]) == len(out[1])
    for got, want in zip(*out):
        _assert_batches_equal(got, want)


def test_output_dataset_equals_jax(wav_root, tmp_path):
    for kind, side in (("target", "clean"), ("condition", "noisy"), ("output", "clean")):
        (tmp_path / kind).mkdir()
        for i in range(3):
            name = f"p{i}.wav"
            (tmp_path / kind / name).write_bytes((wav_root / side / name).read_bytes())
    got = tdata.OutputDataset(tmp_path, ".wav", 16000)
    want = jdata.OutputDataset(tmp_path, ".wav", 16000)
    assert len(got) == len(want) == 3
    for i in range(3):
        assert got.get_name(i) == want.get_name(i)
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("datatype", [".wav", ".spec.npy"])
def test_numpy_dataset_equals_jax(datatype, wav_root):
    got = tdata.NumpyDataset(wav_root, datatype, 16000)
    want = jdata.NumpyDataset(wav_root, datatype, 16000)
    assert len(got) == len(want) == 7
    for i in (0, 6):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w) and got.get_name(i) == want.get_name(i)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_wavegrad_collate_at_a_seed_equals_jax(wav_root):
    out = []
    for mod in (tloaders, jloaders):
        ds = mod.DATASETS["NumpyDataset"](wav_root, ".spec.npy", 16000)
        dl = mod.DATA_LOADERS["WaveGradDataLoader"](ds, batch_size=3, hop_samples=64,
                                                    crop_mel_frames=62, num_workers=0)
        out.append(list(dl) + list(dl))
    _assert_batches_equal(*out)
    assert out[0][0][0].shape == (3, 1, 62 * 64)


def test_inventory_and_names_equal_jax(wav_root):
    assert tdata.generate_inventory(wav_root / "clean") == jdata.generate_inventory(
        wav_root / "clean")
    with pytest.raises(FileNotFoundError):
        tdata.generate_inventory(wav_root / "clean", ".mel.npy")
    ds = tdata.AudioDataset(wav_root, ".wav", sample_rate=8000)
    with pytest.raises(ValueError, match="rate"):
        ds[0]
    assert ds.get_name(2) == jdata.AudioDataset(wav_root, ".wav").get_name(2) == "p2"


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("split", ["test", "test_hard"])
def test_corpus_bytes_equal_jax(version, split, tmp_path):
    generate_corpus(tmp_path / "t", 3, seed=2027, split=split, version=version)
    jax_generate_corpus(tmp_path / "j", 3, seed=2027, split=split, version=version)
    for side in ("clean", "noisy"):
        names = sorted(p.name for p in (tmp_path / "j" / side).iterdir())
        assert names == ["u0000.wav", "u0001.wav", "u0002.wav"]
        assert sorted(p.name for p in (tmp_path / "t" / side).iterdir()) == names
        for name in names:
            assert ((tmp_path / "t" / side / name).read_bytes()
                    == (tmp_path / "j" / side / name).read_bytes())


def test_corpus_cli_writes_the_test_split_at_seed_plus_one(tmp_path):
    make_synthetic_corpus.main(["--root", str(tmp_path / "cli"), "--n-train", "1",
                                "--n-test", "2", "--seed", "2026", "--version", "1"])
    jax_generate_corpus(tmp_path / "j", 2, seed=2027, split="test", version=1)
    for name in ("u0000.wav", "u0001.wav"):
        for side in ("clean", "noisy"):
            assert ((tmp_path / "cli" / "test" / side / name).read_bytes()
                    == (tmp_path / "j" / side / name).read_bytes())
    assert len(list((tmp_path / "cli" / "train" / "clean").iterdir())) == 1

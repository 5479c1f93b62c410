"""The port's on-disk formats and loaders (data/io.py, native/, the three
dataset builders, the batched synthetic generator, ``bucket_by_length``)
against the JAX reference, on the CPU.

Fixtures are tests/test_dataset_builders.py's.  Everything discrete is
held equal: arrays, vocabularies, gold alignments and segments, files
written.  The SpeechCOCO builder's MFCCs are held to K5's bound
(rtol 1e-3, atol 2e-3; tests/test_mfcc_pallas.py:33) between the JAX
frontend and the port's plain version.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from multimodalworddiscovery_tpu.core.masking import bucket_by_length as jax_buckets
from multimodalworddiscovery_tpu.data import flickr8k as jf8
from multimodalworddiscovery_tpu.data import flickr30k_entities as jf30
from multimodalworddiscovery_tpu.data import io as jio
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data import mscoco as jcoco
from multimodalworddiscovery_tpu.data.synthetic import make_flickr8k_mini_batches as jax_batches
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames as jax_frames
from multimodalworddiscovery_tpu.frontend.speech import MfccConfig as JaxMfccConfig
from multimodalworddiscovery_tpu.frontend.speech import extract as jax_extract
from multimodalworddiscovery_tpu.native import pack_token_file as jax_pack
from multimodalworddiscovery_tpu_torch import core as tcore
from multimodalworddiscovery_tpu_torch import native as tnative
from multimodalworddiscovery_tpu_torch.core.masking import bucket_by_length
from multimodalworddiscovery_tpu_torch.data import flickr8k as tf8
from multimodalworddiscovery_tpu_torch.data import flickr30k_entities as tf30
from multimodalworddiscovery_tpu_torch.data import io as tio
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini_batches
from multimodalworddiscovery_tpu_torch.data import mscoco as tcoco
from multimodalworddiscovery_tpu_torch.data import phones_to_frames as torch_frames
from multimodalworddiscovery_tpu_torch.frontend.speech import MfccConfig
from multimodalworddiscovery_tpu_torch.frontend.speech import extract as torch_extract

FIELDS = ("src", "src_len", "trg", "trg_len")


def _same_corpus(tc, jc):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)
    assert (tc.src_vocab, tc.trg_vocab) == (jc.src_vocab, jc.trg_vocab)


def _same_gold(tg, jg):
    np.testing.assert_array_equal(tg.alignment, jg.alignment)
    assert [[tuple(s) for s in seg] for seg in tg.segments] == [
        [tuple(s) for s in seg] for seg in jg.segments]


# ---- the packer -----------------------------------------------------------


@pytest.fixture()
def token_file(tmp_path):
    p = tmp_path / "caps.txt"
    p.write_text("1 2 3\n7 8\n\n42\n5 5 5 5 5 5\n")
    return p


def test_packer_python_path_matches_jax(token_file):
    arr, lens, vmax = tnative.pack_token_file(token_file, force_python=True)
    assert arr.shape == (4, 6)  # blank line skipped
    np.testing.assert_array_equal(lens, [3, 2, 1, 6])
    assert vmax == 42
    for got, want in zip((arr, lens, vmax), jax_pack(token_file, force_python=True)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pad_multiple", [1, 8])
def test_packer_matches_jax_on_a_large_random_file(tmp_path, pad_multiple):
    """The port's packer (the C extension where it is built, else the
    Python path) against the JAX package's Python path."""
    rng = np.random.default_rng(0)
    lines = [" ".join(str(int(x)) for x in rng.integers(0, 10000, int(rng.integers(1, 60))))
             for _ in range(500)]
    p = tmp_path / "big.txt"
    p.write_text("\n".join(lines))  # no trailing newline
    got = tnative.pack_token_file(p, pad_multiple=pad_multiple)
    want = jax_pack(p, pad_multiple=pad_multiple, force_python=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[1] % pad_multiple == 0


# ---- data/io --------------------------------------------------------------


@pytest.fixture(scope="module")
def corpora():
    gen = dict(n_utterances=12, seed=4)
    jc, jgold, _ = jax_make(**gen)
    tc, tgold, _ = torch_make(**gen, device="cpu")
    jfc, jfg, _ = jax_frames(jc, jgold, feat_dim=6, seed=1)
    tfc, tfg, _ = torch_frames(tc, tgold, feat_dim=6, seed=1, device="cpu")
    return (jc, jgold, tc, tgold), (jfc, jfg, tfc, tfg)


@pytest.mark.parametrize("kind", ["ids", "frames"])
def test_save_corpus_files_equal_jax(tmp_path, corpora, kind):
    """The port writes the JAX package's files: token text and gold JSON
    byte for byte, feature archives with equal arrays."""
    jc, jgold, tc, tgold = corpora[kind == "frames"]
    jio.save_corpus(jc, jgold, tmp_path / "j", "c")
    tio.save_corpus(tc, tgold, tmp_path / "t", "c")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for name in names:
        a, b = tmp_path / "j" / name, tmp_path / "t" / name
        if name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k])
        else:
            assert a.read_bytes() == b.read_bytes(), name


@pytest.mark.parametrize("kind", ["ids", "frames"])
def test_load_corpus_reads_jax_files_and_back(tmp_path, corpora, kind):
    """Both directions: the port loads what the JAX package saved, and the
    JAX package loads what the port saved."""
    jc, jgold, tc, tgold = corpora[kind == "frames"]
    jio.save_corpus(jc, jgold, tmp_path / "j", "c")
    got, gold = tio.load_corpus(tmp_path / "j", "c", device="cpu")
    want, want_gold = jio.load_corpus(tmp_path / "j", "c")
    _same_corpus(got, want)
    _same_gold(gold, want_gold)
    tio.save_corpus(tc, tgold, tmp_path / "t", "c")
    back, back_gold = jio.load_corpus(tmp_path / "t", "c")
    _same_corpus(tio.load_corpus(tmp_path / "t", "c", device="cpu")[0], back)
    _same_gold(back_gold, gold)


def test_load_corpus_symbolic_and_signed_tokens(tmp_path):
    """Symbolic tokens build a sorted vocabulary, as in the JAX package.  A
    signed token takes the Python path there too; a negative id, which the
    JAX package keeps, is refused by the port's Corpus (its kernels index
    tables with the ids unchecked)."""
    (tmp_path / "s_src.txt").write_text("b a c\n\nc c\n")
    (tmp_path / "s_trg.txt").write_text("+1 4\n2\n")
    got, gold = tio.load_corpus(tmp_path, "s", device="cpu")
    want, _ = jio.load_corpus(tmp_path, "s")
    assert gold is None
    _same_corpus(got, want)
    assert (got.src_vocab, got.trg_vocab) == (4, 4)  # "+1" is a symbol there too
    (tmp_path / "s_trg.txt").write_text("-1 4\n2\n")
    with pytest.raises(ValueError, match="ids must lie"):
        tio.load_corpus(tmp_path, "s", device="cpu")
    with pytest.raises(FileNotFoundError, match="missing_src"):
        tio.load_corpus(tmp_path, "missing", device="cpu")


def test_alignment_json_equal_jax(tmp_path, corpora):
    jc, jgold, tc, tgold = corpora[0]
    jio.save_alignment_json(jgold.alignment, np.asarray(jc.src_len), tmp_path / "j.json",
                            segments=jgold.segments)
    tio.save_alignment_json(tgold.alignment, tc.src_len.numpy(), tmp_path / "t.json",
                            segments=tgold.segments)
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    _same_gold(tio.load_alignment_json(tmp_path / "j.json", jc.n, jc.max_src_len), jgold)


# ---- the dataset builders (tests/test_dataset_builders.py's fixtures) -----


@pytest.fixture()
def flickr_files(tmp_path):
    (tmp_path / "Flickr8k.token.txt").write_text(
        "1.jpg#0\tA dog chases the ball .\n"
        "1.jpg#1\tThe dog runs fast\n"
        "2.jpg#0\tA cat sits on grass\n"
        "3.jpg#0\tunknownimage caption\n"
    )
    (tmp_path / "lexicon.txt").write_text(
        "a AH\ndog D AO G\nchases CH EY S IH Z\nthe DH AH\nball B AO L\n"
        "runs R AH N Z\nfast F AE S T\ncat K AE T\nsits S IH T S\n"
        "on AA N\ngrass G R AE S\n"
    )
    (tmp_path / "concepts.txt").write_text("1.jpg dog ball\n2.jpg cat grass\n")
    (tmp_path / "wav2capt.txt").write_text("a.wav 1.jpg #0\nb.wav 2.jpg #3\nbad line\n")
    return tmp_path


def test_flickr8k_builder_matches_jax(flickr_files, tmp_path):
    d = flickr_files
    args = (d / "Flickr8k.token.txt", d / "lexicon.txt", d / "concepts.txt")
    corpus, gold, meta = tf8.build_corpus(*args, device="cpu")
    jc, jgold, jmeta = jf8.build_corpus(*args)
    _same_corpus(corpus, jc)
    _same_gold(gold, jgold)
    assert meta == jmeta and corpus.n == 3
    assert tf8.read_wav2capt(d / "wav2capt.txt") == jf8.read_wav2capt(d / "wav2capt.txt")
    assert tf8.read_captions(args[0]) == jf8.read_captions(args[0])
    assert tf8.read_concepts(args[2]) == jf8.read_concepts(args[2])
    tio.save_corpus(corpus, gold, tmp_path / "out", "flickr8k")
    loaded, gold2 = tio.load_corpus(tmp_path / "out", "flickr8k", device="cpu")
    np.testing.assert_array_equal(loaded.src.numpy(), corpus.src.numpy())
    np.testing.assert_array_equal(gold2.alignment, gold.alignment)


@pytest.fixture()
def coco_files(tmp_path):
    instances = {
        "categories": [{"id": 1, "name": "dog"}, {"id": 2, "name": "frisbee"},
                       {"id": 3, "name": "traffic light"}],
        "annotations": [
            {"image_id": 10, "category_id": 1},
            {"image_id": 10, "category_id": 2},
            {"image_id": 10, "category_id": 1},
            {"image_id": 20, "category_id": 2},
            {"image_id": 20, "category_id": 3},
        ],
        "images": [{"id": 10}, {"id": 20}],
    }
    captions = {"annotations": [
        {"image_id": 10, "caption": "a dog catches a frisbee"},
        {"image_id": 20, "caption": "a frisbee on grass by the light"},
    ]}
    (tmp_path / "instances.json").write_text(json.dumps(instances))
    (tmp_path / "captions.json").write_text(json.dumps(captions))
    (tmp_path / "lexicon.txt").write_text(
        "a AH\ndog D AO G\ncatches K AE CH IH Z\nfrisbee F R IH Z B IY\n"
        "on AA N\ngrass G R AE S\nlight L AY T\n"
    )
    (tmp_path / "manifest.tsv").write_text(
        "w1.wav\t10\ta dog catches a frisbee\nw2.wav\t20\ta frisbee on grass\n"
        "w3.wav\t99\tno instances\n"
    )
    return tmp_path


def test_mscoco_builder_matches_jax(coco_files):
    d = coco_files
    args = (d / "instances.json", d / "captions.json", d / "lexicon.txt")
    corpus, gold, meta = tcoco.build_corpus(*args, device="cpu")
    jc, jgold, jmeta = jcoco.build_corpus(*args)
    _same_corpus(corpus, jc)
    _same_gold(gold, jgold)
    assert meta == jmeta
    assert tcoco.read_speechcoco_manifest(d / "manifest.tsv") == \
        jcoco.read_speechcoco_manifest(d / "manifest.tsv")


def test_speechcoco_builder_matches_jax(coco_files):
    """The same waveforms through the JAX frontend and the port's plain
    MFCC: equal lengths and concepts, features within K5's bound."""
    d = coco_files
    wavs = {f"w{i}.wav": np.random.default_rng(i).normal(size=4000 + 160 * i).astype(
        np.float32) * 0.1 for i in (1, 2, 3)}
    corpus, meta = tcoco.build_speech_corpus(
        d / "manifest.tsv", d / "instances.json", wavs.__getitem__,
        lambda w, n: torch_extract(w, n, MfccConfig()), device="cpu")
    jc, jmeta = jcoco.build_speech_corpus(
        d / "manifest.tsv", d / "instances.json", wavs.__getitem__,
        lambda w, n: jax_extract(jnp.asarray(w), jnp.asarray(n), JaxMfccConfig()))
    assert meta == jmeta and corpus.n == 2 and corpus.src.shape[-1] == 13
    for f in ("src_len", "trg", "trg_len"):
        np.testing.assert_array_equal(getattr(corpus, f).numpy(), np.asarray(getattr(jc, f)))
    np.testing.assert_allclose(corpus.src.numpy(), np.asarray(jc.src), rtol=1e-3, atol=2e-3)


def test_flickr30k_parsers_match_jax(tmp_path):
    for line in ("[/EN#40331/people A young woman] looks at [/EN#40332/other a book] quietly .",
                 "[/EN#0/notvisible Nothing] here", "[/EN#7 An untyped] mention"):
        assert tf30.parse_sentence(line) == jf30.parse_sentence(line)
    (tmp_path / "100.xml").write_text(
        "<annotation><size><width>200</width><height>100</height></size>"
        "<object><name>1</name><bndbox><xmin>20</xmin><ymin>10</ymin>"
        "<xmax>120</xmax><ymax>60</ymax></bndbox></object>"
        "<object><name>1</name><name>2</name><bndbox><xmin>0</xmin><ymin>0</ymin>"
        "<xmax>200</xmax><ymax>100</ymax></bndbox></object>"
        "<object><name>3</name></object></annotation>"
    )
    assert tf30.parse_boxes(tmp_path / "100.xml") == jf30.parse_boxes(tmp_path / "100.xml")


@pytest.mark.parametrize("concept_from", ["category", "head"])
def test_flickr30k_builder_matches_jax(tmp_path, concept_from):
    d = tmp_path / "Sentences"
    d.mkdir()
    (d / "100.txt").write_text(
        "[/EN#1/people A man] rides [/EN#2/vehicles a red bike]\n"
        "[/EN#1/people The man] sits\n"
    )
    (d / "200.txt").write_text("[/EN#3/animals A dog] chases [/EN#4/other a ball]\n")
    (tmp_path / "lex.txt").write_text(
        "a AH\nman M AE N\nrides R AY D Z\nred R EH D\nbike B AY K\n"
        "the DH AH\nsits S IH T S\ndog D AO G\nchases CH EY S\nball B AO L\n"
    )
    corpus, gold, meta = tf30.build_corpus(d, tmp_path / "lex.txt", concept_from,
                                           device="cpu")
    jc, jgold, jmeta = jf30.build_corpus(d, tmp_path / "lex.txt", concept_from)
    _same_corpus(corpus, jc)
    _same_gold(gold, jgold)
    assert meta == jmeta and corpus.n == 3


# ---- the batched generator and bucket_by_length ---------------------------


@pytest.mark.parametrize("batch_size", [7, 50])
def test_flickr8k_mini_batches_match_monolithic(batch_size):
    """The batches concatenated equal ``make_flickr8k_mini`` row for row
    (tests/test_data.py:72), and the JAX package's batches."""
    ref, ref_gold, ref_meta = torch_make(n_utterances=50, seed=4, device="cpu")
    meta, s_max, batches = make_flickr8k_mini_batches(50, batch_size, seed=4, device="cpu")
    jmeta, js_max, jbatches = jax_batches(50, batch_size, seed=4)
    assert meta.lexicon == ref_meta.lexicon == jmeta.lexicon and s_max == js_max
    rows = 0
    t = ref.max_src_len
    for (corpus, gold), (jc, jgold) in zip(batches, jbatches):
        b = corpus.n
        _same_corpus(corpus, jc)
        _same_gold(gold, jgold)
        assert corpus.max_src_len == s_max
        np.testing.assert_array_equal(corpus.src[:, :t].numpy(), ref.src[rows:rows + b].numpy())
        assert int(corpus.src[:, t:].abs().sum()) == 0
        np.testing.assert_array_equal(corpus.src_len.numpy(), ref.src_len[rows:rows + b].numpy())
        np.testing.assert_array_equal(corpus.trg[:, : ref.max_trg_len].numpy(),
                                      ref.trg[rows:rows + b].numpy())
        np.testing.assert_array_equal(gold.alignment[:, :t], ref_gold.alignment[rows:rows + b])
        assert gold.segments == ref_gold.segments[rows:rows + b]
        rows += b
    assert rows == 50


def test_bucket_by_length_matches_jax():
    lengths = np.array([1, 5, 10, 11, 16, 17, 40, 0])
    for edges in ([10], [5, 16], [10, 20, 30]):
        np.testing.assert_array_equal(bucket_by_length(lengths, edges),
                                      jax_buckets(lengths, edges))
    assert "bucket_by_length" not in tcore.__all__  # as the reference's core

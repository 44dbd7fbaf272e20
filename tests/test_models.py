"""Batch codec models: padding, config plumbing, bit-exact round trips."""

import numpy as np
import pytest

import jax.numpy as jnp

from cute_nucleotides_jax.models import Base5Codec, CodecConfig, TwoBitCodec, pad_batch
from cute_nucleotides_jax.ops import oracle, spec


def test_pad_batch_list():
    batch, lengths = pad_batch([b"ACGT", b"ACGTACG"], 32)
    assert batch.shape == (2, 32)
    assert lengths.tolist() == [4, 7]
    assert bytes(batch[0][:4]) == b"ACGT" and batch[0][4] == ord("A")


def test_pad_batch_array(rng):
    arr = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(3, 40))
    batch, lengths = pad_batch(arr, 32)
    assert batch.shape == (3, 64) and lengths.tolist() == [40, 40, 40]


@pytest.mark.parametrize("variant", ["mul", "shift", "interleave"])
def test_two_bit_codec_matches_oracle(rng, variant):
    codec = TwoBitCodec(tier="xla", encode_variant=variant)
    reads = [b"ACGTacgtUUGG" * 5, b"A" * 7, b"ttttGGGGccccAAAA" * 3]
    batch, lengths = codec.pad(reads)
    words = np.asarray(codec.encode(jnp.asarray(batch)))
    for i, r in enumerate(reads):
        want = oracle.n_to_bits_lut(np.frombuffer(r, np.uint8))
        got = spec.u32_pairs_to_u64(words[i])[: want.size]
        assert np.array_equal(got, want)


def test_two_bit_roundtrip(rng):
    codec = TwoBitCodec(tier="xla")
    batch = rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=(4, 64))
    back = np.asarray(codec.decode(codec.encode(jnp.asarray(batch))))
    want = np.frombuffer(
        batch.tobytes().upper().replace(b"U", b"T"), np.uint8
    ).reshape(4, 64)
    assert np.array_equal(back, want)


def test_base5_codec_matches_oracle(rng):
    codec = Base5Codec(tier="xla")
    batch = rng.choice(np.frombuffer(b"ACGTUNacgtun", np.uint8), size=(4, 108))
    words = np.asarray(codec.encode(jnp.asarray(batch)))
    for i in range(4):
        assert np.array_equal(
            spec.u32_pairs_to_u64(words[i]), oracle.n_to_bits2_lut(batch[i])
        )


def test_base5_roundtrip(rng):
    codec = Base5Codec(tier="xla")
    batch = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(2, 54))
    back = np.asarray(codec.decode(codec.encode(jnp.asarray(batch))))
    assert np.array_equal(back, batch)


def test_config_resolution():
    cfg = CodecConfig(tier="auto")
    assert cfg.resolved_tier() == "xla"
    assert TwoBitCodec(tier="xla").tier == "xla"
    assert TwoBitCodec(CodecConfig(tier="xla"), encode_variant="shift").config.encode_variant == "shift"


def test_default_tier_raises_on_unknown_backend(monkeypatch):
    import jax

    from cute_nucleotides_jax import models as m

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert m._default_tier() == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "quantum")
    with pytest.raises(RuntimeError, match="no codec tier"):
        m._default_tier()
    with pytest.raises(RuntimeError, match="no codec tier"):
        TwoBitCodec(tier="auto")


@pytest.mark.parametrize("tier", ["auto", "xla"])
def test_twobit_encode_checked(tier, rng):
    codec = TwoBitCodec(tier=tier)
    s = rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=(4, 512))
    words, bad = codec.encode_checked(jnp.asarray(s))
    assert np.array_equal(np.asarray(words), np.asarray(codec.encode(jnp.asarray(s))))
    assert not np.asarray(bad).any()
    s[2, 100] = ord("N")  # invalid for the 2-bit alphabet
    _, bad = codec.encode_checked(jnp.asarray(s))
    assert list(np.asarray(bad)) == [False, False, True, False]


@pytest.mark.parametrize("tier", ["auto", "xla"])
def test_base5_encode_checked(tier, rng):
    codec = Base5Codec(tier=tier)
    s = rng.choice(np.frombuffer(b"ACGTUNacgtun", np.uint8), size=(4, 27 * 19))
    words, bad = codec.encode_checked(jnp.asarray(s))
    assert np.array_equal(np.asarray(words), np.asarray(codec.encode(jnp.asarray(s))))
    assert not bool(np.any(np.asarray(bad)))
    s[1, 3] = ord("X")
    _, bad = codec.encode_checked(jnp.asarray(s))
    assert bool(np.any(np.asarray(bad)))


@pytest.mark.parametrize("tier", ["auto", "xla"])
def test_base5_decode_checked(tier, rng):
    codec = Base5Codec(tier=tier)
    s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(4, 27 * 19))
    words = np.asarray(codec.encode(jnp.asarray(s))).copy()
    out, bad = codec.decode_checked(jnp.asarray(words))
    assert np.array_equal(np.asarray(out), np.asarray(codec.decode(jnp.asarray(words))))
    assert not bool(np.any(np.asarray(bad)))
    # corrupt one word: out-of-range triplet in row 2
    words[2, 4] |= np.uint32(0x7F)
    _, bad = codec.decode_checked(jnp.asarray(words))
    assert bool(np.any(np.asarray(bad)))


def test_tier_exclusive_variants_raise_clearly():
    with pytest.raises(ValueError, match="unknown encode_variant"):
        TwoBitCodec(tier="xla", encode_variant="mxu")
    with pytest.raises(ValueError, match="unknown decode_variant"):
        TwoBitCodec(tier="xla", decode_variant="pdep")
    with pytest.raises(ValueError, match="unknown codec tier"):
        TwoBitCodec(tier="pallas")
    with pytest.raises(ValueError, match="unknown codec tier"):
        Base5Codec(tier="pallas")


def test_encode_checked_fallback_jit_is_cached():
    from cute_nucleotides_jax import models as m

    assert m._jit_decode_b5_checked() is m._jit_decode_b5_checked()


def test_default_variants_resolve_to_tier_champions():
    """Each tier's default is its fastest measured form (PERF.md): the
    SWAR encoders tie and "mul" is kept; decode "swar"."""
    from cute_nucleotides_jax import models as m

    xla_cfg = m.CodecConfig(tier="xla")
    assert xla_cfg.resolved_encode_variant() == "mul"
    assert xla_cfg.resolved_decode_variant() == "swar"
    assert m.default_encode_variant("oracle") == "lut"
    assert m.default_decode_variant("auto") == "swar"
    # explicit choices always win over the champion table
    assert m.CodecConfig(tier="xla", encode_variant="dot").resolved_encode_variant() == "dot"
    # the constructed codecs carry the resolved forms
    codec = TwoBitCodec(tier="xla")
    assert codec.encode_variant == "mul" and codec.decode_variant == "swar"
    # free-function API resolves through the same table and stays bit-exact
    from cute_nucleotides_jax import api
    from cute_nucleotides_jax.ops import oracle

    s = np.frombuffer(b"ACGTacgtUuACGTacgtUuACGTacgtUuAC", np.uint8)
    assert np.array_equal(api.n_to_bits(s, tier="xla"), oracle.n_to_bits_lut(s))
    w = oracle.n_to_bits_lut(s)
    assert bytes(api.bits_to_n(w, s.size, tier="xla")) == bytes(
        oracle.bits_to_n_lut(w, s.size)
    )


def test_api_rejects_unknown_tier_and_resolves_auto():
    import pytest

    from cute_nucleotides_jax import api
    from cute_nucleotides_jax.ops import oracle

    s = np.frombuffer(b"ACGTNacgtnACGTNacgtnACGTNac", np.uint8)
    for fn, args in (
        (api.n_to_bits, (s,)),
        (api.bits_to_n, (oracle.n_to_bits_lut(s), s.size)),
        (api.n_to_bits2, (s,)),
        (api.bits_to_n2, (oracle.n_to_bits2_lut(s), s.size)),
    ):
        with pytest.raises(ValueError, match="unknown tier"):
            fn(*args, tier="nonsense")
    # the host C++ tier lives at ops.native; point there instead of KeyError
    with pytest.raises(ValueError, match="ops.native"):
        api.n_to_bits(s, tier="native")
    # "auto" resolves to the backend's tier (xla on CPU) and stays bit-exact
    assert np.array_equal(api.n_to_bits(s, tier="auto"), oracle.n_to_bits_lut(s))
    w2 = oracle.n_to_bits2_lut(s)
    assert np.array_equal(api.n_to_bits2(s, tier="auto"), w2)
    assert bytes(api.bits_to_n2(w2, s.size, tier="auto")) == bytes(
        oracle.bits_to_n2_lut(w2, s.size)
    )


def test_api_validate_kwarg():
    from cute_nucleotides_jax import api

    assert api.n_to_bits(b"ACGTacgtu" + b"A" * 23, validate=True).size == 1
    assert api.n_to_bits2(b"ACGTN" * 6, validate=True).size == 2
    with pytest.raises(ValueError, match=r"invalid byte b'N' at position 2"):
        api.n_to_bits(b"ACNT", validate=True)  # N invalid in the 2-bit set
    with pytest.raises(ValueError, match=r"invalid byte b'@' at position 5"):
        api.n_to_bits2(b"ACGTN@", validate=True)
    # unvalidated stays on the defined out-of-alphabet contract
    assert api.n_to_bits(b"ACNT").size == 1

"""The benchmark's plain reference decoder equals the port's reference
backend at small sizes on the CPU, for both codes and other frames."""
import pytest
import torch
from portbench_tmp import BIG_SEED, one_thread  # noqa: F401

from portbench.reference import channel, viterbi

K7 = (7, (0o171, 0o133))
GALILEO = (15, (0o46321, 0o51271, 0o63667, 0o70535))
PAPER = dict(f=256, v1=20, v2=45, f0=32, v2s=45, start="boundary")


def _port(llr, k, polys, spec):
    from repro_torch.core.framed import FrameSpec
    from repro_torch.core.pipeline import DecoderConfig, make_decoder
    from repro_torch.core.trellis import make_trellis
    cfg = DecoderConfig(trellis=make_trellis(k, polys),
                        spec=FrameSpec(**spec), backend="reference")
    return make_decoder(cfg, "cpu")(llr, llr.shape[0])


def _llr(k, polys, n, ebn0, seed=BIG_SEED):
    gen = channel.generator(seed, "cpu")
    bits = channel.info_bits(gen, (n,))
    return bits, channel.received_llr(channel.encode(bits, k, polys), ebn0,
                                      gen)


@pytest.mark.parametrize("n,ebn0", [(3000, 3.0), (1000, -2.0), (700, 1.0)])
def test_k7_equals_the_ports_reference_backend(n, ebn0):
    bits, llr = _llr(*K7, n, ebn0)
    ours = viterbi.decode(llr, *K7, PAPER)
    assert ours.dtype == torch.int32 and ours.shape == (n,)
    assert torch.equal(ours, _port(llr, *K7, PAPER))


@pytest.mark.parametrize("ebn0", [0.0, -4.0])
def test_galileo_equals_the_ports_reference_backend(ebn0):
    bits, llr = _llr(*GALILEO, 600, ebn0)
    assert torch.equal(viterbi.decode(llr, *GALILEO, PAPER),
                       _port(llr, *GALILEO, PAPER))


@pytest.mark.parametrize("spec", [
    dict(f=64, v1=10, v2=20, f0=0, v2s=0, start="boundary"),
    dict(f=64, v1=10, v2=20, f0=16, v2s=12, start="fixed"),
    dict(f=96, v1=0, v2=30, f0=32, v2s=30, start="boundary")])
def test_other_frames_equal_the_ports_reference_backend(spec):
    bits, llr = _llr(*K7, 1111, 0.5)
    assert torch.equal(viterbi.decode(llr, *K7, spec),
                       _port(llr, *K7, spec))


def test_blocks_of_frames_do_not_change_the_bits():
    _, llr = _llr(*K7, 2000, 1.0)
    whole = viterbi.decode(llr, *K7, PAPER)
    small = viterbi.decode(llr, *K7, PAPER, survivor_budget=1)
    assert torch.equal(whole, small)


def test_a_clean_channel_decodes_the_sent_bits():
    bits, llr = _llr(*K7, 4000, 8.0)
    assert torch.equal(viterbi.decode(llr, *K7, PAPER), bits.to(torch.int32))


def test_edge_words_are_the_trellis_outputs():
    from repro_torch.core.trellis import make_trellis
    for k, polys in (K7, GALILEO):
        want = make_trellis(k, polys).prev_out
        assert (viterbi.edge_words(k, polys).numpy() == want).all()


def test_reference_bits_refuses_a_punctured_rate():
    cfg = {"code": {"k": 7, "rate": "3/4", "generators_octal": ["171", "133"]},
           "frame": PAPER}
    with pytest.raises(ValueError):
        viterbi.reference_bits(cfg, torch.zeros((10, 2)))

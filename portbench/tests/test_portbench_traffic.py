"""The traffic comes from the seed alone, and the channel follows the
code's convention."""
import torch
from portbench_tmp import BIG_SEED, ROOT, one_thread  # noqa: F401

from portbench.cells import load_cell
from portbench.harness import make_inputs
from portbench.reference import channel


def _tiny(cell, n=2048, pool=3):
    import dataclasses
    return dataclasses.replace(cell, traffic={**cell.traffic,
                                              "bits_per_call": n,
                                              "pool": pool})


def test_the_same_seed_gives_the_same_traffic():
    cell = _tiny(load_cell(ROOT, "k7_r12_batch"))
    a = make_inputs(cell, BIG_SEED, "cpu")
    b = make_inputs(cell, BIG_SEED, "cpu")
    c = make_inputs(cell, BIG_SEED + 1, "cpu")
    assert torch.equal(a.llr, b.llr) and torch.equal(a.bits, b.bits)
    assert a.order == b.order and sorted(a.order) == [0, 1, 2]
    assert not torch.equal(a.llr, c.llr)
    assert a.llr.shape == (3, 2048, 2) and a.llr.dtype == torch.float32
    assert a.bits.shape == (3, 2048)


def test_every_seed_gives_the_same_amount_of_work():
    cell = _tiny(load_cell(ROOT, "k7_r12_batch"))
    shapes = {tuple(make_inputs(cell, s, "cpu").llr.shape)
              for s in (0, 1, (1 << 63) + 5, BIG_SEED)}
    assert shapes == {(3, 2048, 2)}


def test_the_encoder_is_the_codes_own():
    from repro_torch.core.encoder import encode_bits
    from repro_torch.core.trellis import make_trellis
    gen = channel.generator(BIG_SEED, "cpu")
    for k, polys in ((7, (0o171, 0o133)),
                     (15, (0o46321, 0o51271, 0o63667, 0o70535))):
        bits = channel.info_bits(gen, (500,))
        ours = channel.encode(bits, k, polys)
        want = encode_bits(bits.numpy(), make_trellis(k, polys))
        assert ours.dtype == torch.int8
        assert (ours.numpy() == want).all()


def test_the_noise_follows_the_stated_ebn0():
    gen = channel.generator(3, "cpu")
    coded = torch.zeros((200000, 2), dtype=torch.int8)
    rx = channel.received_llr(coded, 3.0, gen)
    sigma = float((rx - 1.0).std())
    assert abs(sigma - 10 ** (-3.0 / 20)) < 0.01
    assert channel.noise_sigma(0.0) == 1.0

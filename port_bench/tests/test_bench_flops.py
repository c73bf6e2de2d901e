"""The model FLOPs counted from the configurations."""

from port_bench.harness import model_flops, spec


def _cfg(name):
    return spec.resolve(name).config


def _config_file(name):
    """A configuration file that no listed cell names yet."""
    return spec._json(spec.ROOT / "configs" / f"{name}.json")


def test_stream_frame_flops_scale():
    cfg = _cfg("moss_serve16")
    f = model_flops.stream_frame_flops(cfg)
    # ~4.9 TFLOP for 250 tokens counted from one eager run of the program
    # (PERF.md, kv_api); the model's own count lies near it
    assert 3e9 < f < 6e9
    cfg2 = dict(cfg, serving=dict(cfg["serving"], ring_tokens=70))
    assert model_flops.stream_frame_flops(cfg2) > f


def test_offline_v1_flops_grow_faster_than_length():
    cfg = _config_file("cosyvoice1_decoder_22k")
    a = model_flops.offline_v1_flops(cfg, 1000)
    b = model_flops.offline_v1_flops(cfg, 1500)
    assert b > 1.5 * a
    assert model_flops.v1_mel_len(cfg, 500) == 861


def test_hift_frame_flops():
    cfg = _cfg("moss_serve16")
    assert 4e8 < model_flops.hift_frame_flops(cfg["hift"]) < 9e8

"""Data preparation tools of the port (the JAX package's ``bin/tools.py``;
the reference's tools/extract_speech_token.py, make_parquet_list.py and
rebatch.py):

    python -m moss_speech_decoder_cosy_torch.bin.tools extract_tokens \
        --wav_scp wav.scp --output tokens.jsonl [--tokenizer_ckpt T] \
        [--device cpu]
    python -m moss_speech_decoder_cosy_torch.bin.tools make_parquet \
        --wav_scp wav.scp [--token_jsonl tokens.jsonl] --output_dir D
    python -m moss_speech_decoder_cosy_torch.bin.tools rebatch \
        --input_list data.list --output_dir D [--num_utts_per_parquet N]

``extract_tokens`` reads the wavs on 8 threads and tokenizes on the card
through the port's ``SpeechCodec``; the parquet tools need pyarrow.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor


def extract_tokens(args):
    """wav.scp (``utt path`` lines) -> a jsonl of ``{"utt",
    "speech_token"}``."""
    from ..eval.audio_io import read_wav, resample
    codec = _build_codec(args)

    def load(line):
        utt, path = line.strip().split(maxsplit=1)
        wav, sr = read_wav(path)
        return utt, resample(wav, sr, 16000)

    with open(args.wav_scp) as f:
        lines = [ln for ln in f if ln.strip()]
    with open(args.output, "w") as out, ThreadPoolExecutor(8) as pool:
        for utt, wav in pool.map(load, lines):
            tokens = codec.encode(wav)[0].tolist()
            out.write(json.dumps({"utt": utt, "speech_token": tokens})
                      + "\n")
    print(f"wrote {args.output} ({len(lines)} utts)")


def _write_shards(rows, output_dir: str, per: int) -> list:
    """Parquet shards of ``per`` rows and their ``data.list``."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i in range(0, len(rows), per):
        p = os.path.join(output_dir, f"parquet_{i // per:09d}.tar")
        pq.write_table(pa.Table.from_pylist(rows[i:i + per]), p)
        paths.append(p)
    with open(os.path.join(output_dir, "data.list"), "w") as f:
        f.write("\n".join(paths) + "\n")
    return paths


def make_parquet(args):
    """wav.scp (and a token jsonl) -> parquet shards with ``utt``,
    ``speech``, ``sample_rate`` (and ``speech_token``) columns."""
    from ..eval.audio_io import read_wav
    tokens = {}
    if args.token_jsonl:
        with open(args.token_jsonl) as f:
            for ln in f:
                rec = json.loads(ln)
                tokens[rec["utt"]] = rec["speech_token"]
    rows = []
    with open(args.wav_scp) as f:
        for ln in f:
            if not ln.strip():
                continue
            utt, path = ln.strip().split(maxsplit=1)
            wav, sr = read_wav(path)
            row = {"utt": utt, "speech": wav.tolist(), "sample_rate": sr}
            if utt in tokens:
                row["speech_token"] = tokens[utt]
            rows.append(row)
    paths = _write_shards(rows, args.output_dir, args.num_utts_per_parquet)
    print(f"wrote {len(paths)} shards to {args.output_dir}")


def rebatch(args):
    """Re-shards parquet files to another number of rows a shard
    (tools/rebatch.py)."""
    import pyarrow.parquet as pq
    rows = []
    with open(args.input_list) as f:
        for ln in f:
            if ln.strip():
                rows.extend(pq.read_table(ln.strip()).to_pylist())
    paths = _write_shards(rows, args.output_dir, args.num_utts_per_parquet)
    print(f"rebatched {len(rows)} rows into {len(paths)} shards")


def _build_codec(args):
    """The port's codec: seeded MOSS decoder weights, the tokenizer from
    ``--tokenizer_ckpt`` (seeded without one)."""
    from .inference import build_codec
    return build_codec(argparse.Namespace(
        model_dir=None, flow_ckpt=None, hift_ckpt=None,
        tokenizer_ckpt=getattr(args, "tokenizer_ckpt", None),
        flow_version=None, block_size=5, max_token_len=40, bf16=False,
        device=getattr(args, "device", None)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("extract_tokens")
    pe.add_argument("--wav_scp", required=True)
    pe.add_argument("--output", required=True)
    pe.add_argument("--tokenizer_ckpt", default=None)
    pe.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    pm = sub.add_parser("make_parquet")
    pm.add_argument("--wav_scp", required=True)
    pm.add_argument("--token_jsonl", default=None)
    pm.add_argument("--output_dir", required=True)
    pm.add_argument("--num_utts_per_parquet", type=int, default=1000)
    pr = sub.add_parser("rebatch")
    pr.add_argument("--input_list", required=True)
    pr.add_argument("--output_dir", required=True)
    pr.add_argument("--num_utts_per_parquet", type=int, default=1000)
    args = p.parse_args(argv)
    {"extract_tokens": extract_tokens, "make_parquet": make_parquet,
     "rebatch": rebatch}[args.cmd](args)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The port's wire codec (eva_tpu_torch.serialization.wire) beside the
protobuf library on the same message: Sobel 90x90's public context
(N=16384, prime bits [60,20,60,60,60,60,60], 8 rotations), the largest
object of the protocol.

Runs on the host (no card); needs the protobuf package, which the port
does not. protobuf reads the schema through the protoc-generated modules
of eva_tpu/serialization, loaded by path: no module of the eva_tpu
package (and no JAX) is imported, and nothing of it is timed.

Times, each the median of REPS interleaved runs, wall clock, one thread:
  save_s / load_s          the port's save_to_string / load_from_string
                           (device="cpu"; the load includes the SHAKE-128
                           expansion of the seeded key rows and the
                           public context's set-up)
  encode_s / decode_s      the codec alone on the envelope's bytes
  pb_serialize_s           protobuf's SerializeToString(deterministic=True)
                           of the parsed envelope and message
  pb_parse_s               protobuf's ParseFromString of the envelope and
                           of the message it holds
and the bytes of the file. Prints one JSON line.

Run:  python3 tools/wire_vs_protobuf.py [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_torch import build_sobel  # noqa: E402


def _generated_modules():
    """known_type_pb2 and evatpu_pb2 of eva_tpu/serialization, imported by
    path (they import each other as top-level modules)."""
    sys.path.insert(0, os.path.join(ROOT, "eva_tpu", "serialization"))
    import evatpu_pb2
    import known_type_pb2
    return known_type_pb2, evatpu_pb2


def _seconds(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)

    import torch
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.runtime import generate_keys
    from eva_tpu_torch.serialization import (load_from_string,
                                             save_to_string, wire)
    torch.set_num_threads(1)

    _, params, _ = CKKSCompiler({"warn_vec_size": "false"}).compile(
        build_sobel())
    pub, _ = generate_keys(params, device="cpu")
    data = save_to_string(pub)
    known_type_pb2, evatpu_pb2 = _generated_modules()
    env_pb = known_type_pb2.KnownType()
    env_pb.ParseFromString(data)
    msg_pb = evatpu_pb2.EVAPublicMsg()
    msg_pb.ParseFromString(env_pb.contents.value)
    env = wire.decode("KnownType", data)

    def pb_parse():
        e = known_type_pb2.KnownType()
        e.ParseFromString(data)
        evatpu_pb2.EVAPublicMsg().ParseFromString(e.contents.value)

    def pb_serialize():
        msg_pb.SerializeToString(deterministic=True)
        env_pb.SerializeToString(deterministic=True)

    def decode():
        e = wire.decode("KnownType", data)
        wire.decode(wire.any_type_name(e.contents), e.contents.value)

    runs = {"save_s": lambda: save_to_string(pub),
            "load_s": lambda: load_from_string(data, device="cpu"),
            "encode_s": lambda: wire.encode(env),
            "decode_s": decode,
            "pb_serialize_s": pb_serialize,
            "pb_parse_s": pb_parse}
    samples = {k: [] for k in runs}
    for _ in range(args.reps):
        for k, fn in runs.items():
            samples[k].append(_seconds(fn))
    if wire.encode(env) != env_pb.SerializeToString(deterministic=True):
        raise AssertionError("the codec's bytes are not protobuf's "
                             "deterministic bytes")
    import google.protobuf
    from google.protobuf.internal import api_implementation
    line = {"object": "sobel90 public context", "bytes": len(data),
            "protobuf": f"{google.protobuf.__version__} "
                        f"({api_implementation.Type()})",
            **{k: statistics.median(v) for k, v in samples.items()},
            "samples": samples, "host_threads": 1}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

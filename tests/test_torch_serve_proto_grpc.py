"""Protobuf gRPC interop on the port: ``tests/test_serve_proto_grpc.py``
with ``ray_tpu`` read as ``ray_tpu_torch`` and the scheduler's rounds on
the host. A plain grpcio client with its OWN compiled protobuf stubs
(protoc-generated messages, no ray_tpu_torch imports on the "client side")
calls a Serve deployment through the proto ingress, unary and
server-streaming. As in the reference, the service glue that
``grpc_tools`` would generate is written by hand; the messages are
compiled by the real protoc.
"""
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
import ray_tpu_torch.serve as serve
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.core.runtime import set_runtime

@pytest.fixture(scope="module", autouse=True)
def _sched_on_cpu():
    # the port's runtimes bring their scheduler up on cuda and raise
    # without it; here its rounds run on the host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
        yield


_PROTO = """
syntax = "proto3";
package llmsvc;
message GenRequest { string prompt = 1; int32 n = 2; }
message GenReply { string text = 1; }
message Token { string tok = 1; int32 index = 2; }
"""


@pytest.fixture(scope="module")
def pb2(tmp_path_factory):
    d = tmp_path_factory.mktemp("protos")
    (d / "llmsvc.proto").write_text(_PROTO)
    subprocess.run(
        ["protoc", f"--python_out={d}", "llmsvc.proto"],
        cwd=d,
        check=True,
    )
    sys.path.insert(0, str(d))
    try:
        import llmsvc_pb2

        yield llmsvc_pb2
    finally:
        sys.path.remove(str(d))


def _add_llm_servicer_to_server(servicer, server, pb2):
    """What `protoc --grpc_python_out` would generate for service LLM
    { rpc Generate(GenRequest) returns (GenReply); rpc StreamTokens
    (GenRequest) returns (stream Token); }"""
    import grpc

    handlers = {
        "Generate": grpc.unary_unary_rpc_method_handler(
            servicer.Generate,
            request_deserializer=pb2.GenRequest.FromString,
            response_serializer=pb2.GenReply.SerializeToString,
        ),
        "StreamTokens": grpc.unary_stream_rpc_method_handler(
            servicer.StreamTokens,
            request_deserializer=pb2.GenRequest.FromString,
            response_serializer=pb2.Token.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler("llmsvc.LLM", handlers),)
    )


def test_proto_grpc_unary_and_streaming(pb2):
    import grpc

    c = Cluster()
    c.add_node({"CPU": 4.0}, num_workers=2)
    rt = c.client()
    set_runtime(rt)
    try:
        # the user deployment: receives DECODED request messages, returns
        # response messages (its own compiled protos, reference contract)
        proto_dir = [p for p in sys.path if "protos" in p][0]

        @serve.deployment(name="llm", num_replicas=1)
        class LLM:
            def __init__(self):
                sys.path.insert(0, proto_dir)
                import llmsvc_pb2

                self.pb2 = llmsvc_pb2

            def Generate(self, req):
                return self.pb2.GenReply(
                    text=f"{req.prompt}:{req.n}"
                )

            def StreamTokens(self, req):
                for i in range(req.n):
                    yield self.pb2.Token(tok=f"{req.prompt}-{i}", index=i)

        serve.run(LLM.bind())
        addr = serve.start_proto_grpc_ingress(
            [
                (
                    lambda s, srv: _add_llm_servicer_to_server(s, srv, pb2),
                    "llm",
                )
            ]
        )

        # --- the foreign client: grpcio + compiled messages only -------
        channel = grpc.insecure_channel(addr)
        generate = channel.unary_unary(
            "/llmsvc.LLM/Generate",
            request_serializer=pb2.GenRequest.SerializeToString,
            response_deserializer=pb2.GenReply.FromString,
        )
        reply = generate(pb2.GenRequest(prompt="hello", n=7), timeout=120)
        assert reply.text == "hello:7"

        stream = channel.unary_stream(
            "/llmsvc.LLM/StreamTokens",
            request_serializer=pb2.GenRequest.SerializeToString,
            response_deserializer=pb2.Token.FromString,
        )
        toks = list(stream(pb2.GenRequest(prompt="t", n=5), timeout=120))
        assert [t.tok for t in toks] == [f"t-{i}" for i in range(5)]
        assert [t.index for t in toks] == list(range(5))

        # unknown method surfaces UNIMPLEMENTED, not a hang
        bogus = channel.unary_unary(
            "/llmsvc.LLM/Nope",
            request_serializer=pb2.GenRequest.SerializeToString,
            response_deserializer=pb2.GenReply.FromString,
        )
        with pytest.raises(grpc.RpcError):
            bogus(pb2.GenRequest(prompt="x", n=1), timeout=30)
        channel.close()
    finally:
        serve.shutdown()
        set_runtime(None)
        rt.shutdown()
        c.shutdown()

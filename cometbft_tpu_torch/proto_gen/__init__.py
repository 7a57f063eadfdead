"""The port's own copy of the generated ``cometbft.*`` protobuf modules.

The JAX package generates its tree with ``scripts/gen_proto.sh`` (``protoc
-I proto --python_out``, services registered through grpc's generic
handlers, so no grpc plugin).  protoc writes absolute ``from cometbft.X
import Y`` imports, and the JAX package's ``proto_gen/__init__.py`` puts
its own directory on ``sys.path`` to serve them.  This copy does not: in a
process that imports both packages, a top-level ``cometbft`` package would
be whichever package put itself first.  The port's files import each other
through this package instead.  The tree was made from the JAX package's
generated files with::

    cp -r cometbft_tpu/proto_gen/cometbft cometbft_tpu_torch/proto_gen/
    find cometbft_tpu_torch/proto_gen -name '*_pb2.py' -exec sed -i \\
        's/^from cometbft\\./from cometbft_tpu_torch.proto_gen.cometbft./' {} +

and a regeneration repeats those two commands after ``gen_proto.sh``.
Every generated file registers the same serialized ``.proto`` bytes as
the JAX package's, so the default descriptor pool accepts both copies and
a message of one type serialises alike from either package.

The modules import ``google.protobuf``; nothing of the port imports them
unless a gRPC option, the psql sink or ``rpc/pb_convert`` is used.
"""

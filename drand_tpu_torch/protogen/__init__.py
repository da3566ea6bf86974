"""The generated protobuf modules of drand's wire (the port's copy of
`drand_tpu/protogen/`: `common/common.proto`, `crypto/dkg/dkg.proto`,
`drand/drand.proto`), their imports rewritten as package imports, so no
directory is put on `sys.path`:

    from drand_tpu_torch.protogen import common_pb2, drand_pb2

The descriptors go into protobuf's default pool under the same file
names as drand_tpu's, so both packages can load in one process and share
the message classes.  Importing this package needs `protobuf`; nothing of
the port imports it at module load except `net/` and `core/`.
"""

from drand_tpu_torch.protogen.common import common_pb2
from drand_tpu_torch.protogen.crypto.dkg import dkg_pb2
from drand_tpu_torch.protogen.drand import drand_pb2

__all__ = ["common_pb2", "dkg_pb2", "drand_pb2"]

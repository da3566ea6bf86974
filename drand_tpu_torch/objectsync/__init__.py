"""Content-addressed segment sync over dumb object storage (counterpart of
`drand_tpu/objectsync/`).

The chain as static objects: immutable segment objects of 16384 rounds,
named by content hash, plus one small mutable ``manifest.json``,
publishable to a directory or anything a static server or CDN can front.
Clients verify everything against their own anchor, so the storage is
untrusted.

  format.py     object layout and manifest (byte-equal to drand_tpu's)
  backends.py   the ObjectStore seam and the filesystem backend
  publisher.py  the sealed-segment publisher
  client.py     the verify-then-commit sync client
"""

from drand_tpu_torch.objectsync.backends import (FilesystemBackend,
                                                 ObjectNotFound, ObjectStore,
                                                 ObjectStoreError)
from drand_tpu_torch.objectsync.client import (CorruptObjectError,
                                               ObjectSyncClient,
                                               ObjectSyncError, SyncResult)
from drand_tpu_torch.objectsync.format import (DEFAULT_SEGMENT_ROUNDS,
                                               MANIFEST_NAME, Manifest,
                                               ManifestEntry,
                                               ObjectFormatError, Segment,
                                               content_hash, decode_rows,
                                               decode_segment, encode_rows,
                                               encode_segment, object_name)
from drand_tpu_torch.objectsync.publisher import (ObjectPublisher,
                                                  PublisherError)

__all__ = [
    "FilesystemBackend", "ObjectNotFound", "ObjectStore", "ObjectStoreError",
    "CorruptObjectError", "ObjectSyncClient", "ObjectSyncError",
    "SyncResult", "DEFAULT_SEGMENT_ROUNDS", "MANIFEST_NAME", "Manifest",
    "ManifestEntry", "ObjectFormatError", "Segment", "content_hash",
    "decode_rows", "decode_segment", "encode_rows", "encode_segment",
    "object_name", "ObjectPublisher", "PublisherError",
]

# -*- coding: utf-8 -*-
# Generated by tools/gen_drand_pb2.py (protoc-compatible layout).  DO NOT EDIT!
# source: drand/drand.proto
# drand_tpu_torch copy: imports written as package imports, module names
# under drand_tpu_torch.protogen; the descriptors are unchanged.
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from drand_tpu_torch.protogen.common import common_pb2 as common_dot_common__pb2
from drand_tpu_torch.protogen.crypto.dkg import dkg_pb2 as crypto_dot_dkg_dot_dkg__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x11drand/drand.proto\x12\x05drand\x1a\x13common/common.proto\x1a\x14crypto/dkg/dkg.proto"+\n\x05Empty\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"H\n\x08Identity\x12\x0f\n\x07address\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\x0b\n\x03tls\x18\x03 \x01(\x08\x12\x11\n\tsignature\x18\x04 \x01(\x0c"6\n\x04Node\x12\x1f\n\x06public\x18\x01 \x01(\x0b2\x0f.drand.Identity\x12\r\n\x05index\x18\x02 \x01(\r"\xf1\x01\n\x0bGroupPacket\x12\x1a\n\x05nodes\x18\x01 \x03(\x0b2\x0b.drand.Node\x12\x11\n\tthreshold\x18\x02 \x01(\r\x12\x0e\n\x06period\x18\x03 \x01(\r\x12\x14\n\x0cgenesis_time\x18\x04 \x01(\x04\x12\x17\n\x0ftransition_time\x18\x05 \x01(\x04\x12\x14\n\x0cgenesis_seed\x18\x06 \x01(\x0c\x12\x10\n\x08dist_key\x18\x07 \x03(\x0c\x12\x16\n\x0ecatchup_period\x18\x08 \x01(\r\x12\x10\n\x08schemeID\x18\t \x01(\t\x12"\n\x08metadata\x18\n \x01(\x0b2\x10.common.Metadata"2\n\x0cGroupRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"6\n\x10ChainInfoRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"\xa2\x01\n\x0fChainInfoPacket\x12\x12\n\npublic_key\x18\x01 \x01(\x0c\x12\x0e\n\x06period\x18\x02 \x01(\r\x12\x14\n\x0cgenesis_time\x18\x03 \x01(\x03\x12\x0c\n\x04hash\x18\x04 \x01(\x0c\x12\x11\n\tgroupHash\x18\x05 \x01(\x0c\x12\x10\n\x08schemeID\x18\x06 \x01(\t\x12"\n\x08metadata\x18\x07 \x01(\x0b2\x10.common.Metadata"5\n\x0fIdentityRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"t\n\x10IdentityResponse\x12\x0f\n\x07address\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\x0b\n\x03tls\x18\x03 \x01(\x08\x12\x11\n\tsignature\x18\x04 \x01(\x0c\x12"\n\x08metadata\x18\x05 \x01(\x0b2\x10.common.Metadata"\x87\x01\n\x0fSignalDKGPacket\x12\x1d\n\x04node\x18\x01 \x01(\x0b2\x0f.drand.Identity\x12\x14\n\x0csecret_proof\x18\x02 \x01(\x0c\x12\x1b\n\x13previous_group_hash\x18\x03 \x01(\x0c\x12"\n\x08metadata\x18\x04 \x01(\x0b2\x10.common.Metadata"\x98\x01\n\rDKGInfoPacket\x12%\n\tnew_group\x18\x01 \x01(\x0b2\x12.drand.GroupPacket\x12\x14\n\x0csecret_proof\x18\x02 \x01(\x0c\x12\x13\n\x0bdkg_timeout\x18\x03 \x01(\r\x12\x11\n\tsignature\x18\x04 \x01(\x0c\x12"\n\x08metadata\x18\x05 \x01(\x0b2\x10.common.Metadata"s\n\x13PartialBeaconPacket\x12\r\n\x05round\x18\x01 \x01(\x04\x12\x14\n\x0cprevious_sig\x18\x02 \x01(\x0c\x12\x13\n\x0bpartial_sig\x18\x03 \x01(\x0c\x12"\n\x08metadata\x18\x04 \x01(\x0b2\x10.common.Metadata"I\n\tDKGPacket\x12\x18\n\x03dkg\x18\x01 \x01(\x0b2\x0b.dkg.Packet\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata"Y\n\x0bSyncRequest\x12\x12\n\nfrom_round\x18\x01 \x01(\x04\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata\x12\x12\n\nchunk_size\x18\x03 \x01(\r"\x8b\x01\n\x0cBeaconPacket\x12\x14\n\x0cprevious_sig\x18\x01 \x01(\x0c\x12\r\n\x05round\x18\x02 \x01(\x04\x12\x11\n\tsignature\x18\x03 \x01(\x0c\x12"\n\x08metadata\x18\x04 \x01(\x0b2\x10.common.Metadata\x12\x1f\n\x05chunk\x18\x05 \x01(\x0b2\x10.drand.SyncChunk"\x81\x01\n\tSyncChunk\x12\x13\n\x0bstart_round\x18\x01 \x01(\x04\x12\r\n\x05count\x18\x02 \x01(\r\x12\x0f\n\x07sig_len\x18\x03 \x01(\r\x12\x12\n\nsignatures\x18\x04 \x01(\x0c\x12\x1a\n\x12first_previous_sig\x18\x05 \x01(\x0c\x12\x0f\n\x07chained\x18\x06 \x01(\x08"\x1b\n\tDkgStatus\x12\x0e\n\x06status\x18\x01 \x01(\r"\x1f\n\rReshareStatus\x12\x0e\n\x06status\x18\x01 \x01(\r"n\n\x0cBeaconStatus\x12\x0e\n\x06status\x18\x01 \x01(\r\x12\x12\n\nis_running\x18\x02 \x01(\x08\x12\x12\n\nis_stopped\x18\x03 \x01(\x08\x12\x12\n\nis_started\x18\x04 \x01(\x08\x12\x12\n\nis_serving\x18\x05 \x01(\x08"H\n\x10ChainStoreStatus\x12\x10\n\x08is_empty\x18\x01 \x01(\x08\x12\x12\n\nlast_round\x18\x02 \x01(\x04\x12\x0e\n\x06length\x18\x03 \x01(\x04"\'\n\x07Address\x12\x0f\n\x07address\x18\x01 \x01(\t\x12\x0b\n\x03tls\x18\x02 \x01(\x08"W\n\rStatusRequest\x12"\n\ncheck_conn\x18\x01 \x03(\x0b2\x0e.drand.Address\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata"\x9a\x02\n\x0eStatusResponse\x12\x1d\n\x03dkg\x18\x01 \x01(\x0b2\x10.drand.DkgStatus\x12%\n\x07reshare\x18\x02 \x01(\x0b2\x14.drand.ReshareStatus\x12#\n\x06beacon\x18\x03 \x01(\x0b2\x13.drand.BeaconStatus\x12,\n\x0bchain_store\x18\x04 \x01(\x0b2\x17.drand.ChainStoreStatus\x12;\n\x0bconnections\x18\x05 \x03(\x0b2&.drand.StatusResponse.ConnectionsEntry\x1a2\n\x10ConnectionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x08:\x028\x01"F\n\x11PublicRandRequest\x12\r\n\x05round\x18\x01 \x01(\x04\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata"\x8a\x01\n\x12PublicRandResponse\x12\r\n\x05round\x18\x01 \x01(\x04\x12\x11\n\tsignature\x18\x02 \x01(\x0c\x12\x1a\n\x12previous_signature\x18\x03 \x01(\x0c\x12\x12\n\nrandomness\x18\x04 \x01(\x0c\x12"\n\x08metadata\x18\x05 \x01(\x0b2\x10.common.Metadata"I\n\x12PrivateRandRequest\x12\x0f\n\x07request\x18\x01 \x01(\x0c\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata"K\n\x13PrivateRandResponse\x12\x10\n\x08response\x18\x01 \x01(\x0c\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata"1\n\x0bHomeRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"B\n\x0cHomeResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata"\xee\x01\n\x0fSetupInfoPacket\x12\x0e\n\x06leader\x18\x01 \x01(\x08\x12\x16\n\x0eleader_address\x18\x02 \x01(\t\x12\x12\n\nleader_tls\x18\x03 \x01(\x08\x12\r\n\x05nodes\x18\x04 \x01(\r\x12\x11\n\tthreshold\x18\x05 \x01(\r\x12\x0f\n\x07timeout\x18\x06 \x01(\r\x12\x15\n\rbeacon_offset\x18\x07 \x01(\r\x12\x12\n\ndkg_offset\x18\x08 \x01(\r\x12\x0e\n\x06secret\x18\t \x01(\x0c\x12\r\n\x05force\x18\n \x01(\x08\x12"\n\x08metadata\x18\x0b \x01(\x0b2\x10.common.Metadata"\xbf\x01\n\rInitDKGPacket\x12$\n\x04info\x18\x01 \x01(\x0b2\x16.drand.SetupInfoPacket\x12#\n\x07entropy\x18\x02 \x01(\x0b2\x12.drand.EntropyInfo\x12\x15\n\rbeacon_period\x18\x03 \x01(\r\x12\x16\n\x0ecatchup_period\x18\x04 \x01(\r\x12\x10\n\x08schemeID\x18\x05 \x01(\t\x12"\n\x08metadata\x18\x06 \x01(\x0b2\x10.common.Metadata"S\n\x0bEntropyInfo\x12\x0e\n\x06script\x18\x01 \x01(\t\x12\x10\n\x08userOnly\x18\n \x01(\x08\x12"\n\x08metadata\x18\x0b \x01(\x0b2\x10.common.Metadata"\xb4\x01\n\x11InitResharePacket\x12\x1d\n\x03old\x18\x01 \x01(\x0b2\x10.drand.GroupInfo\x12$\n\x04info\x18\x02 \x01(\x0b2\x16.drand.SetupInfoPacket\x12\x1e\n\x16catchup_period_changed\x18\x03 \x01(\x08\x12\x16\n\x0ecatchup_period\x18\x04 \x01(\r\x12"\n\x08metadata\x18\x05 \x01(\x0b2\x10.common.Metadata"6\n\tGroupInfo\x12\x0e\n\x04path\x18\x01 \x01(\tH\x00\x12\r\n\x03url\x18\x02 \x01(\tH\x00B\n\n\x08location"2\n\x0cShareRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"Q\n\rShareResponse\x12\r\n\x05index\x18\x02 \x01(\r\x12\r\n\x05share\x18\x03 \x01(\x0c\x12"\n\x08metadata\x18\x04 \x01(\x0b2\x10.common.Metadata"*\n\x04Ping\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"*\n\x04Pong\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"\\\n\x13RemoteStatusRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata\x12!\n\taddresses\x18\x02 \x03(\x0b2\x0e.drand.Address"\x9b\x01\n\x14RemoteStatusResponse\x12;\n\x08statuses\x18\x01 \x03(\x0b2).drand.RemoteStatusResponse.StatusesEntry\x1aF\n\rStatusesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12$\n\x05value\x18\x02 \x01(\x0b2\x15.drand.StatusResponse:\x028\x01"8\n\x12ListSchemesRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"F\n\x13ListSchemesResponse\x12\x0b\n\x03ids\x18\x01 \x03(\t\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata":\n\x14ListBeaconIDsRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"H\n\x15ListBeaconIDsResponse\x12\x0b\n\x03ids\x18\x01 \x03(\t\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata"6\n\x10PublicKeyRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"G\n\x11PublicKeyResponse\x12\x0e\n\x06pubKey\x18\x02 \x01(\x0c\x12"\n\x08metadata\x18\x03 \x01(\x0b2\x10.common.Metadata"7\n\x11PrivateKeyRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"H\n\x12PrivateKeyResponse\x12\x0e\n\x06priKey\x18\x02 \x01(\x0c\x12"\n\x08metadata\x18\x03 \x01(\x0b2\x10.common.Metadata"5\n\x0fShutdownRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"6\n\x10ShutdownResponse\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"7\n\x11LoadBeaconRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"8\n\x12LoadBeaconResponse\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"{\n\x10StartSyncRequest\x12\x15\n\tinfo_hash\x18\x01 \x01(\tB\x02\x18\x01\x12\r\n\x05nodes\x18\x02 \x03(\t\x12\x0e\n\x06is_tls\x18\x03 \x01(\x08\x12\r\n\x05up_to\x18\x04 \x01(\x04\x12"\n\x08metadata\x18\x05 \x01(\x0b2\x10.common.Metadata"S\n\x0cSyncProgress\x12\x0f\n\x07current\x18\x01 \x01(\x04\x12\x0e\n\x06target\x18\x02 \x01(\x04\x12"\n\x08metadata\x18\x03 \x01(\x0b2\x10.common.Metadata"J\n\x0fBackupDBRequest\x12\x13\n\x0boutput_file\x18\x01 \x01(\t\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata"6\n\x10BackupDBResponse\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"4\n\x0eMetricsRequest\x12"\n\x08metadata\x18\x01 \x01(\x0b2\x10.common.Metadata"F\n\x0fMetricsResponse\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata"f\n\x12GossipPeersRequest\x12\r\n\x05topic\x18\x01 \x01(\t\x12\x0e\n\x06sender\x18\x02 \x01(\t\x12\r\n\x05known\x18\x03 \x03(\t\x12"\n\x08metadata\x18\x04 \x01(\x0b2\x10.common.Metadata"H\n\x13GossipPeersResponse\x12\r\n\x05peers\x18\x01 \x03(\t\x12"\n\x08metadata\x18\x02 \x01(\x0b2\x10.common.Metadata2\x95\x03\n\x08Protocol\x12>\n\x0bGetIdentity\x12\x16.drand.IdentityRequest\x1a\x17.drand.IdentityResponse\x12<\n\x14SignalDKGParticipant\x12\x16.drand.SignalDKGPacket\x1a\x0c.drand.Empty\x121\n\x0bPushDKGInfo\x12\x14.drand.DKGInfoPacket\x1a\x0c.drand.Empty\x12.\n\x0cBroadcastDKG\x12\x10.drand.DKGPacket\x1a\x0c.drand.Empty\x129\n\rPartialBeacon\x12\x1a.drand.PartialBeaconPacket\x1a\x0c.drand.Empty\x126\n\tSyncChain\x12\x12.drand.SyncRequest\x1a\x13.drand.BeaconPacket0\x01\x125\n\x06Status\x12\x14.drand.StatusRequest\x1a\x15.drand.StatusResponse2\xcb\x02\n\x06Public\x12A\n\nPublicRand\x12\x18.drand.PublicRandRequest\x1a\x19.drand.PublicRandResponse\x12I\n\x10PublicRandStream\x12\x18.drand.PublicRandRequest\x1a\x19.drand.PublicRandResponse0\x01\x12D\n\x0bPrivateRand\x12\x19.drand.PrivateRandRequest\x1a\x1a.drand.PrivateRandResponse\x12<\n\tChainInfo\x12\x17.drand.ChainInfoRequest\x1a\x16.drand.ChainInfoPacket\x12/\n\x04Home\x12\x12.drand.HomeRequest\x1a\x13.drand.HomeResponse2\xa8\x08\n\x07Control\x12$\n\x08PingPong\x12\x0b.drand.Ping\x1a\x0b.drand.Pong\x125\n\x06Status\x12\x14.drand.StatusRequest\x1a\x15.drand.StatusResponse\x12D\n\x0bListSchemes\x12\x19.drand.ListSchemesRequest\x1a\x1a.drand.ListSchemesResponse\x12J\n\rListBeaconIDs\x12\x1b.drand.ListBeaconIDsRequest\x1a\x1c.drand.ListBeaconIDsResponse\x123\n\x07InitDKG\x12\x14.drand.InitDKGPacket\x1a\x12.drand.GroupPacket\x12;\n\x0bInitReshare\x12\x18.drand.InitResharePacket\x1a\x12.drand.GroupPacket\x122\n\x05Share\x12\x13.drand.ShareRequest\x1a\x14.drand.ShareResponse\x12>\n\tPublicKey\x12\x17.drand.PublicKeyRequest\x1a\x18.drand.PublicKeyResponse\x12A\n\nPrivateKey\x12\x18.drand.PrivateKeyRequest\x1a\x19.drand.PrivateKeyResponse\x12<\n\tChainInfo\x12\x17.drand.ChainInfoRequest\x1a\x16.drand.ChainInfoPacket\x124\n\tGroupFile\x12\x13.drand.GroupRequest\x1a\x12.drand.GroupPacket\x12;\n\x08Shutdown\x12\x16.drand.ShutdownRequest\x1a\x17.drand.ShutdownResponse\x12A\n\nLoadBeacon\x12\x18.drand.LoadBeaconRequest\x1a\x19.drand.LoadBeaconResponse\x12B\n\x10StartFollowChain\x12\x17.drand.StartSyncRequest\x1a\x13.drand.SyncProgress0\x01\x12A\n\x0fStartCheckChain\x12\x17.drand.StartSyncRequest\x1a\x13.drand.SyncProgress0\x01\x12A\n\x0eBackupDatabase\x12\x16.drand.BackupDBRequest\x1a\x17.drand.BackupDBResponse\x12G\n\x0cRemoteStatus\x12\x1a.drand.RemoteStatusRequest\x1a\x1b.drand.RemoteStatusResponse2J\n\x0eMetricsService\x128\n\x07Metrics\x12\x15.drand.MetricsRequest\x1a\x16.drand.MetricsResponse2K\n\x06Gossip\x12A\n\x08Exchange\x12\x19.drand.GossipPeersRequest\x1a\x1a.drand.GossipPeersResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'drand_tpu_torch.protogen.drand.drand_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _STATUSRESPONSE_CONNECTIONSENTRY._options = None
  _STATUSRESPONSE_CONNECTIONSENTRY._serialized_options = b'8\x01'
  _REMOTESTATUSRESPONSE_STATUSESENTRY._options = None
  _REMOTESTATUSRESPONSE_STATUSESENTRY._serialized_options = b'8\x01'
  _STARTSYNCREQUEST.fields_by_name['info_hash']._options = None
  _STARTSYNCREQUEST.fields_by_name['info_hash']._serialized_options = b'\x18\x01'
  _EMPTY._serialized_start=71
  _EMPTY._serialized_end=114
  _IDENTITY._serialized_start=116
  _IDENTITY._serialized_end=188
  _NODE._serialized_start=190
  _NODE._serialized_end=244
  _GROUPPACKET._serialized_start=247
  _GROUPPACKET._serialized_end=488
  _GROUPREQUEST._serialized_start=490
  _GROUPREQUEST._serialized_end=540
  _CHAININFOREQUEST._serialized_start=542
  _CHAININFOREQUEST._serialized_end=596
  _CHAININFOPACKET._serialized_start=599
  _CHAININFOPACKET._serialized_end=761
  _IDENTITYREQUEST._serialized_start=763
  _IDENTITYREQUEST._serialized_end=816
  _IDENTITYRESPONSE._serialized_start=818
  _IDENTITYRESPONSE._serialized_end=934
  _SIGNALDKGPACKET._serialized_start=937
  _SIGNALDKGPACKET._serialized_end=1072
  _DKGINFOPACKET._serialized_start=1075
  _DKGINFOPACKET._serialized_end=1227
  _PARTIALBEACONPACKET._serialized_start=1229
  _PARTIALBEACONPACKET._serialized_end=1344
  _DKGPACKET._serialized_start=1346
  _DKGPACKET._serialized_end=1419
  _SYNCREQUEST._serialized_start=1421
  _SYNCREQUEST._serialized_end=1510
  _BEACONPACKET._serialized_start=1513
  _BEACONPACKET._serialized_end=1652
  _SYNCCHUNK._serialized_start=1655
  _SYNCCHUNK._serialized_end=1784
  _DKGSTATUS._serialized_start=1786
  _DKGSTATUS._serialized_end=1813
  _RESHARESTATUS._serialized_start=1815
  _RESHARESTATUS._serialized_end=1846
  _BEACONSTATUS._serialized_start=1848
  _BEACONSTATUS._serialized_end=1958
  _CHAINSTORESTATUS._serialized_start=1960
  _CHAINSTORESTATUS._serialized_end=2032
  _ADDRESS._serialized_start=2034
  _ADDRESS._serialized_end=2073
  _STATUSREQUEST._serialized_start=2075
  _STATUSREQUEST._serialized_end=2162
  _STATUSRESPONSE._serialized_start=2165
  _STATUSRESPONSE._serialized_end=2447
  _STATUSRESPONSE_CONNECTIONSENTRY._serialized_start=2397
  _STATUSRESPONSE_CONNECTIONSENTRY._serialized_end=2447
  _PUBLICRANDREQUEST._serialized_start=2449
  _PUBLICRANDREQUEST._serialized_end=2519
  _PUBLICRANDRESPONSE._serialized_start=2522
  _PUBLICRANDRESPONSE._serialized_end=2660
  _PRIVATERANDREQUEST._serialized_start=2662
  _PRIVATERANDREQUEST._serialized_end=2735
  _PRIVATERANDRESPONSE._serialized_start=2737
  _PRIVATERANDRESPONSE._serialized_end=2812
  _HOMEREQUEST._serialized_start=2814
  _HOMEREQUEST._serialized_end=2863
  _HOMERESPONSE._serialized_start=2865
  _HOMERESPONSE._serialized_end=2931
  _SETUPINFOPACKET._serialized_start=2934
  _SETUPINFOPACKET._serialized_end=3172
  _INITDKGPACKET._serialized_start=3175
  _INITDKGPACKET._serialized_end=3366
  _ENTROPYINFO._serialized_start=3368
  _ENTROPYINFO._serialized_end=3451
  _INITRESHAREPACKET._serialized_start=3454
  _INITRESHAREPACKET._serialized_end=3634
  _GROUPINFO._serialized_start=3636
  _GROUPINFO._serialized_end=3690
  _SHAREREQUEST._serialized_start=3692
  _SHAREREQUEST._serialized_end=3742
  _SHARERESPONSE._serialized_start=3744
  _SHARERESPONSE._serialized_end=3825
  _PING._serialized_start=3827
  _PING._serialized_end=3869
  _PONG._serialized_start=3871
  _PONG._serialized_end=3913
  _REMOTESTATUSREQUEST._serialized_start=3915
  _REMOTESTATUSREQUEST._serialized_end=4007
  _REMOTESTATUSRESPONSE._serialized_start=4010
  _REMOTESTATUSRESPONSE._serialized_end=4165
  _REMOTESTATUSRESPONSE_STATUSESENTRY._serialized_start=4095
  _REMOTESTATUSRESPONSE_STATUSESENTRY._serialized_end=4165
  _LISTSCHEMESREQUEST._serialized_start=4167
  _LISTSCHEMESREQUEST._serialized_end=4223
  _LISTSCHEMESRESPONSE._serialized_start=4225
  _LISTSCHEMESRESPONSE._serialized_end=4295
  _LISTBEACONIDSREQUEST._serialized_start=4297
  _LISTBEACONIDSREQUEST._serialized_end=4355
  _LISTBEACONIDSRESPONSE._serialized_start=4357
  _LISTBEACONIDSRESPONSE._serialized_end=4429
  _PUBLICKEYREQUEST._serialized_start=4431
  _PUBLICKEYREQUEST._serialized_end=4485
  _PUBLICKEYRESPONSE._serialized_start=4487
  _PUBLICKEYRESPONSE._serialized_end=4558
  _PRIVATEKEYREQUEST._serialized_start=4560
  _PRIVATEKEYREQUEST._serialized_end=4615
  _PRIVATEKEYRESPONSE._serialized_start=4617
  _PRIVATEKEYRESPONSE._serialized_end=4689
  _SHUTDOWNREQUEST._serialized_start=4691
  _SHUTDOWNREQUEST._serialized_end=4744
  _SHUTDOWNRESPONSE._serialized_start=4746
  _SHUTDOWNRESPONSE._serialized_end=4800
  _LOADBEACONREQUEST._serialized_start=4802
  _LOADBEACONREQUEST._serialized_end=4857
  _LOADBEACONRESPONSE._serialized_start=4859
  _LOADBEACONRESPONSE._serialized_end=4915
  _STARTSYNCREQUEST._serialized_start=4917
  _STARTSYNCREQUEST._serialized_end=5040
  _SYNCPROGRESS._serialized_start=5042
  _SYNCPROGRESS._serialized_end=5125
  _BACKUPDBREQUEST._serialized_start=5127
  _BACKUPDBREQUEST._serialized_end=5201
  _BACKUPDBRESPONSE._serialized_start=5203
  _BACKUPDBRESPONSE._serialized_end=5257
  _METRICSREQUEST._serialized_start=5259
  _METRICSREQUEST._serialized_end=5311
  _METRICSRESPONSE._serialized_start=5313
  _METRICSRESPONSE._serialized_end=5383
  _GOSSIPPEERSREQUEST._serialized_start=5385
  _GOSSIPPEERSREQUEST._serialized_end=5487
  _GOSSIPPEERSRESPONSE._serialized_start=5489
  _GOSSIPPEERSRESPONSE._serialized_end=5561
# @@protoc_insertion_point(module_scope)

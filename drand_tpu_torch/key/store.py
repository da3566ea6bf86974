"""The on-disk key store (counterpart of `drand_tpu/key/store.py`, drand
`key/store.go`): key pair, group, share and distributed public key as
TOML files under <base>/multibeacon/<beacon id>/{key,groups}/, folders
0700, files 0600."""

from __future__ import annotations

import os

from drand_tpu_torch import fs, toml_util
from drand_tpu_torch.common import MULTIBEACON_FOLDER, canonical_beacon_id
from drand_tpu_torch.key.group import Group
from drand_tpu_torch.key.keys import DistPublic, Pair, Share

KEY_FILE = "drand_id.private"
PUBLIC_FILE = "drand_id.public"
GROUP_FILE = "drand_group.toml"
SHARE_FILE = "dist_key.private"
DIST_KEY_FILE = "dist_key.public"


class FileStore:
    def __init__(self, base_folder: str, beacon_id: str | None = None):
        self.beacon_id = canonical_beacon_id(beacon_id)
        self.base = base_folder
        self.beacon_folder = os.path.join(
            base_folder, MULTIBEACON_FOLDER, self.beacon_id)
        self.key_folder = fs.create_secure_folder(
            os.path.join(self.beacon_folder, "key"))
        self.group_folder = fs.create_secure_folder(
            os.path.join(self.beacon_folder, "groups"))
        self.db_folder = fs.create_secure_folder(
            os.path.join(self.beacon_folder, "db"))

    def _read(self, folder: str, name: str) -> dict:
        with open(os.path.join(folder, name), "rb") as f:
            return toml_util.loads(f.read().decode())

    def _write(self, folder: str, name: str, doc: dict) -> None:
        fs.write_secure_file(os.path.join(folder, name),
                             toml_util.dumps(doc).encode())

    def save_key_pair(self, pair: Pair) -> None:
        self._write(self.key_folder, KEY_FILE, pair.to_dict())
        self._write(self.key_folder, PUBLIC_FILE, pair.public.to_dict())

    def load_key_pair(self) -> Pair:
        return Pair.from_dict(self._read(self.key_folder, KEY_FILE))

    def save_group(self, group: Group) -> None:
        fs.write_secure_file(os.path.join(self.group_folder, GROUP_FILE),
                             group.to_toml().encode())

    def load_group(self) -> Group:
        with open(os.path.join(self.group_folder, GROUP_FILE), "rb") as f:
            return Group.from_toml(f.read().decode())

    def save_share(self, share: Share) -> None:
        self._write(self.key_folder, SHARE_FILE, share.to_dict())

    def load_share(self) -> Share:
        return Share.from_dict(self._read(self.key_folder, SHARE_FILE))

    def save_dist_public(self, dp: DistPublic) -> None:
        self._write(self.key_folder, DIST_KEY_FILE,
                    {"Coefficients": dp.to_list()})

    def load_dist_public(self) -> DistPublic:
        return DistPublic.from_list(
            self._read(self.key_folder, DIST_KEY_FILE)["Coefficients"])

    def has_key_pair(self) -> bool:
        return fs.file_exists(os.path.join(self.key_folder, KEY_FILE))

    def has_group(self) -> bool:
        return fs.file_exists(os.path.join(self.group_folder, GROUP_FILE))

    def has_share(self) -> bool:
        return fs.file_exists(os.path.join(self.key_folder, SHARE_FILE))

    @staticmethod
    def list_beacon_ids(base_folder: str) -> list[str]:
        return fs.list_subfolders(os.path.join(base_folder,
                                               MULTIBEACON_FOLDER))

"""Key material of a node (counterpart of `drand_tpu/key/`, drand `key/`):

  keys.py   `Identity`, `Pair`, `DistPublic`, `Share`
  group.py  `Group`, `Node`, `minimum_threshold`
  store.py  `FileStore`, the TOML files under
            <base>/multibeacon/<beacon id>/{key,groups,db}/

A key, group or share file written by either package loads in the other,
and writing it back gives the same bytes.
"""

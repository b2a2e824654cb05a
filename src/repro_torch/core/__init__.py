"""Hash families, minwise hashing and OPH, b-bit codes and their
packing, the scheme registry, the expansion, VW and random projections,
and the estimators (counterpart of ``repro/core``).  The reference's jnp
paths ``minhash_jnp`` and ``oph_bin_minima_jnp`` are ``minhash_torch``
and ``oph_bin_minima_torch`` here."""
from repro_torch.core import estimators
from repro_torch.core.bbit import (bbit_codes, codes_agree, pack_codes,
                                   storage_bits, unpack_codes,
                                   vw_storage_bits)
from repro_torch.core.expansion import (compact_index, expand,
                                        expansion_offsets, linear_forward,
                                        pb_hat)
from repro_torch.core.minhash import (collision_probability, minhash_batch,
                                      minhash_numpy, minhash_torch)
from repro_torch.core.oph import (OPH_EMPTY_CODE, OPHHash, densify_rotation,
                                  densify_rotation_numpy,
                                  oph_bin_minima_numpy, oph_bin_minima_torch,
                                  oph_codes_agree, oph_codes_numpy,
                                  oph_collision_probability,
                                  split_zero_codes)
from repro_torch.core.random_projection import (rp_inner_product,
                                                rp_project_batch,
                                                rp_project_sparse)
from repro_torch.core.schemes import (SCHEMES, HashingScheme, make_scheme,
                                      register_scheme)
from repro_torch.core.types import SparseBatch, resemblance
from repro_torch.core.universal_hash import (ModPrimeHash, MultiplyShiftHash,
                                             PermutationHash,
                                             make_hash_family)
from repro_torch.core.vw import (vw_hash_batch, vw_hash_sparse,
                                 vw_inner_product)

__all__ = [
    "SparseBatch", "resemblance",
    "ModPrimeHash", "MultiplyShiftHash", "PermutationHash",
    "make_hash_family",
    "minhash_torch", "minhash_batch", "minhash_numpy",
    "collision_probability",
    "bbit_codes", "pack_codes", "unpack_codes", "storage_bits",
    "vw_storage_bits", "codes_agree",
    "OPH_EMPTY_CODE", "OPHHash", "densify_rotation",
    "densify_rotation_numpy", "oph_bin_minima_torch",
    "oph_bin_minima_numpy", "oph_codes_numpy", "oph_collision_probability",
    "oph_codes_agree", "split_zero_codes",
    "SCHEMES", "HashingScheme", "make_scheme", "register_scheme",
    "expand", "expansion_offsets", "linear_forward", "pb_hat",
    "compact_index",
    "vw_hash_sparse", "vw_hash_batch", "vw_inner_product",
    "rp_project_sparse", "rp_project_batch", "rp_inner_product",
    "estimators",
]

"""Integer instructions that the window stage of a batch's multi-scalar
multiplication needs: per point a 4-bit window table and 64 windows of
four doublings and one addition, over the ``2m + 1`` points of a batch of
``m`` signatures (each signature's R and A, and the base point).

The instruction costs of the field and point formulas are counted at the
granularity of the card's integer instructions (IMAD, LOP3, LEA.HI,
IADD3) for 16 limbs of 16 bits held in 64-bit words:

- a carry pass is, per limb, a mask and the neighbour's carry shifted and
  added (two), and one multiply-add folding x38 into limb 0: four passes of
  16 x 2 + 1;
- a product: per limb product a multiply-add, a mask for its low half, one
  shift-and-add of its high half into the next column and half a
  three-input add of its low half (256 x 7 / 2), the 2^256 fold (16), the
  carry;
- a squaring: the same columns from 136 limb products and one doubling
  multiply-add a column (32), then the fold and the carry;
- an addition or subtraction: 16 limb adds and the carry;
- an extended-coordinates point addition: 9 products, 5 additions, 4
  subtractions; a doubling: 4 squarings, 4 products, 2 additions, 6
  subtractions.

A window table holds 0..15 multiples of its point: 14 additions past the
point itself. The first window's doublings act on the identity and are
not needed: 63 windows of 4 doublings, 64 additions.
"""

CARRY = 4 * (16 * 2 + 1)
FE_MUL = 256 * 7 // 2 + 16 + CARRY
FE_SQR = 136 * 7 // 2 + 32 + 16 + CARRY
FE_ADD = 16 + CARRY
FE_SUB = 16 + CARRY
POINT_ADD = 9 * FE_MUL + 5 * FE_ADD + 4 * FE_SUB
POINT_DBL = 4 * FE_SQR + 4 * FE_MUL + 2 * FE_ADD + 6 * FE_SUB
PER_POINT = 14 * POINT_ADD + 63 * 4 * POINT_DBL + 64 * POINT_ADD


def ops_needed(signatures: int) -> int:
    """Instructions for a batch of ``signatures`` signatures."""
    return (2 * signatures + 1) * PER_POINT if signatures else 0

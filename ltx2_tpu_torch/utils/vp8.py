"""A WebP lossy (VP8 key frame) decoder in numpy, bit for bit libwebp's
(RFC 6386): the boolean entropy decoder, the frame, segment and filter
headers, the quantizer tables, the coefficient-probability updates and
token decoding, 16x16, 4x4 and chroma intra prediction, the inverse DCT and
Walsh-Hadamard transforms, the simple and normal loop filters, and
libwebp's YUV -> RGB: its default "fancy" chroma upsampling and its
fixed-point constants.

The entropy decoding and the intra prediction are serial and run in
Python; the transforms run vectorized over every block of the frame, the
loop filter over each edge of a macroblock, the upsampling and the colour
conversion over the whole frame. Tables are the specification's; the 4x4
intra modes are numbered in the order DC, TM, VE, HE, RD, VR, LD, VL, HD,
HU (libwebp's), and the key-frame mode probabilities are laid out in it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# The dc and ac quantizer step of each index 0-127 (RFC 6386, section 14.1).
DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
)
AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
)
# Default coefficient probabilities [4 types][8 bands][3 contexts][11] (RFC 6386, 13.5), flat.
COEFF_PROBA0 = (
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
)
# Their update probabilities, same layout (RFC 6386, 13.4).
COEFF_UPDATE_PROBA = (
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
)
# Key-frame 4x4 mode probabilities [top mode][left mode][9], flat, in this
# module's mode order DC, TM, VE, HE, RD, VR, LD, VL, HD, HU (RFC 6386, 11.5).
BMODES_PROBA = (
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)  # the 17th: a sentinel past the last coefficient
CAT_PROBAS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# The 4x4 mode tree: a node's two children, a leaf as -mode (RFC 6386, 11.2).
YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
DC_PRED, TM_PRED, V_PRED, H_PRED = B_DC, B_TM, B_VE, B_HE
NUM_TYPES, NUM_BANDS, NUM_CTX, NUM_PROBAS = 4, 8, 3, 11
# Shifts that bring a range below 128 back to [128, 255].
_NORM = [0] + [8 - r.bit_length() for r in range(1, 256)]


class VP8Error(ValueError):
    pass


class BoolDecoder:
    """The boolean entropy decoder over data[start:end]; past the end it reads
    zeros, as libwebp does."""

    __slots__ = ("data", "pos", "end", "value", "bits", "range")

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value, self.bits, self.range = 0, -8, 255

    def _load(self) -> None:
        n = min(7, self.end - self.pos)
        if n > 0:
            self.value = (self.value << (8 * n)) | int.from_bytes(self.data[self.pos:self.pos + n], "big")
            self.pos += n
            self.bits += 8 * n
        else:
            self.value <<= 8
            self.bits += 8

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << self.bits
        if self.value >= big:
            self.range -= split
            self.value -= big
            b = 1
        else:
            self.range = split
            b = 0
        if self.range < 128:
            s = _NORM[self.range]
            self.range <<= s
            self.bits -= s
        return b

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(128) else v


def _large_value(br: BoolDecoder, p) -> int:
    bit = br.bit
    if not bit(p[3]):
        return 2 if not bit(p[4]) else 3 + bit(p[5])
    if not bit(p[6]):
        if not bit(p[7]):
            return 5 + bit(159)
        return 7 + 2 * bit(165) + bit(145)
    b1 = bit(p[8])
    cat = 2 * b1 + bit(p[9 + b1])
    v = 0
    for prob in CAT_PROBAS[cat]:
        v = v + v + bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: BoolDecoder, bands, ctx: int, dq_dc: int, dq_ac: int, first: int, out: List[int], base: int) -> int:
    """One block's tokens from coefficient `first`, dequantized into
    out[base + raster index]; returns the index past the last one decoded
    (`first` for an immediate end of block)."""
    bit = br.bit
    n = first
    p = bands[n][ctx]
    while n < 16:
        if not bit(p[0]):
            return n
        while not bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        if not bit(p[2]):
            v, nxt = 1, 1
        else:
            v, nxt = _large_value(br, p), 2
        if bit(128):
            v = -v
        out[base + ZIGZAG[n]] = v * (dq_ac if n else dq_dc)
        n += 1
        p = bands[n][nxt]
    return 16


def _clip(v: int, hi: int) -> int:
    return 0 if v < 0 else hi if v > hi else v


class _Frame:
    """A parsed key frame: sizes, filter parameters and per-macroblock modes,
    segments and dequantized coefficients."""


def _parse(data: bytes) -> _Frame:
    if len(data) < 10:
        raise VP8Error("VP8: truncated frame header")
    tag = data[0] | data[1] << 8 | data[2] << 16
    if tag & 1:
        raise VP8Error("VP8: not a key frame")
    if (tag >> 1) & 7 > 3:
        raise VP8Error("VP8: incorrect keyframe parameters")
    part0 = tag >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise VP8Error("VP8: bad start code")
    f = _Frame()
    f.width = (data[6] | data[7] << 8) & 0x3FFF
    f.height = (data[8] | data[9] << 8) & 0x3FFF
    if not f.width or not f.height or 10 + part0 > len(data):
        raise VP8Error("VP8: bad frame size or first partition")
    f.mb_w, f.mb_h = (f.width + 15) >> 4, (f.height + 15) >> 4
    br = BoolDecoder(data, 10, 10 + part0)
    get = br.bit
    get(128)  # colour space
    get(128)  # clamping type
    # Segment header.
    use_segment = get(128)
    update_map, absolute_delta = 0, 0
    quantizer, filter_strength, seg_probas = [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = get(128)
        if get(128):
            absolute_delta = get(128)
            quantizer = [br.signed_value(7) if get(128) else 0 for _ in range(4)]
            filter_strength = [br.signed_value(6) if get(128) else 0 for _ in range(4)]
        if update_map:
            seg_probas = [br.value_bits(8) if get(128) else 255 for _ in range(3)]
    # Filter header.
    simple = get(128)
    level = br.value_bits(6)
    sharpness = br.value_bits(3)
    use_lf_delta = get(128)
    ref_lf_delta, mode_lf_delta = [0] * 4, [0] * 4
    if use_lf_delta and get(128):
        for i in range(4):
            if get(128):
                ref_lf_delta[i] = br.signed_value(6)
        for i in range(4):
            if get(128):
                mode_lf_delta[i] = br.signed_value(6)
    f.filter_type = 0 if level == 0 else 1 if simple else 2
    # Partitions.
    num_parts = 1 << br.value_bits(2)
    sizes_at = 10 + part0
    start = sizes_at + 3 * (num_parts - 1)
    if start > len(data):
        raise VP8Error("VP8: truncated partition sizes")
    parts = []
    left = len(data) - start
    for p in range(num_parts - 1):
        size = min(int.from_bytes(data[sizes_at + 3 * p:sizes_at + 3 * p + 3], "little"), left)
        parts.append(BoolDecoder(data, start, start + size))
        start += size
        left -= size
    parts.append(BoolDecoder(data, start, len(data)))
    # Quantizers.
    base_q = br.value_bits(7)
    deltas = [br.signed_value(4) if get(128) else 0 for _ in range(5)]  # y1 dc, y2 dc, y2 ac, uv dc, uv ac
    dqm = []
    for s in range(4):
        if use_segment:
            q = quantizer[s] + (0 if absolute_delta else base_q)
        else:
            q = base_q
        y2_ac = AC_TABLE[_clip(q + deltas[2], 127)] * 101581 >> 16
        dqm.append(((DC_TABLE[_clip(q + deltas[0], 127)], AC_TABLE[_clip(q, 127)]),
                    (DC_TABLE[_clip(q + deltas[1], 127)] * 2, max(y2_ac, 8)),
                    (DC_TABLE[_clip(q + deltas[3], 117)], AC_TABLE[_clip(q + deltas[4], 127)])))
    get(128)  # refresh entropy probabilities: ignored for a single key frame
    # Coefficient probabilities.
    proba = []
    i = 0
    f.proba_updates = 0
    for t in range(NUM_TYPES):
        bands = []
        for b in range(NUM_BANDS):
            ctxs = []
            for c in range(NUM_CTX):
                row = []
                for _ in range(NUM_PROBAS):
                    if get(COEFF_UPDATE_PROBA[i]):
                        row.append(br.value_bits(8))
                        f.proba_updates += 1
                    else:
                        row.append(COEFF_PROBA0[i])
                    i += 1
                ctxs.append(row)
            bands.append(ctxs)
        proba.append([bands[BANDS[n]] for n in range(17)])
    use_skip = get(128)
    skip_p = br.value_bits(8) if use_skip else 0
    # Filter strengths per (segment, i4x4): (limit, interior limit, hev threshold).
    f.fstrengths = [[(0, 0, 0), (0, 0, 0)] for _ in range(4)]
    if f.filter_type:
        for s in range(4):
            base_level = level
            if use_segment:
                base_level = filter_strength[s] + (0 if absolute_delta else level)
            for i4 in (0, 1):
                lv = base_level
                if use_lf_delta:
                    lv += ref_lf_delta[0] + (mode_lf_delta[0] if i4 else 0)
                lv = _clip(lv, 63)
                if lv > 0:
                    ilevel = lv
                    if sharpness > 0:
                        ilevel >>= 2 if sharpness > 4 else 1
                        ilevel = min(ilevel, 9 - sharpness)
                    ilevel = max(ilevel, 1)
                    f.fstrengths[s][i4] = (2 * lv + ilevel, ilevel, 2 if lv >= 40 else 1 if lv >= 15 else 0)

    # Macroblocks: modes from the first partition, tokens from row y's partition.
    n_mb = f.mb_w * f.mb_h
    f.is4 = [False] * n_mb
    f.ymode = [0] * n_mb
    f.imodes = [None] * n_mb
    f.uvmode = [0] * n_mb
    f.segment = [0] * n_mb
    coeffs = [0] * (384 * n_mb)
    intra_t = [B_DC] * (4 * f.mb_w)
    top_nz = [[0] * 9 for _ in range(f.mb_w)]  # 4 luma, 2 u, 2 v, the Y2 flag
    for mb_y in range(f.mb_h):
        token_br = parts[mb_y & (num_parts - 1)]
        intra_l = [B_DC] * 4
        left_nz = [0] * 9
        for mb_x in range(f.mb_w):
            m = mb_y * f.mb_w + mb_x
            # Intra modes.
            if update_map:
                seg = get(seg_probas[1]) if not get(seg_probas[0]) else 2 + get(seg_probas[2])
            else:
                seg = 0
            f.segment[m] = seg
            skip = get(skip_p) if use_skip else 0
            is4 = not get(145)
            f.is4[m] = is4
            top = intra_t
            tx = 4 * mb_x
            if not is4:
                ymode = (TM_PRED if get(128) else H_PRED) if get(156) else (V_PRED if get(163) else DC_PRED)
                f.ymode[m] = ymode
                top[tx:tx + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                modes = []
                for y in range(4):
                    ymode = intra_l[y]
                    for x in range(4):
                        p = 90 * top[tx + x] + 9 * ymode
                        i = YMODES_INTRA4[get(BMODES_PROBA[p])]
                        while i > 0:
                            i = YMODES_INTRA4[2 * i + get(BMODES_PROBA[p + i])]
                        ymode = -i
                        top[tx + x] = ymode
                    modes.extend(top[tx:tx + 4])
                    intra_l[y] = ymode
                f.imodes[m] = modes
            f.uvmode[m] = DC_PRED if not get(142) else V_PRED if not get(114) else TM_PRED if get(183) else H_PRED
            # Tokens.
            tnz = top_nz[mb_x]
            if skip:
                for k in range(8):
                    tnz[k] = left_nz[k] = 0
                if not is4:
                    tnz[8] = left_nz[8] = 0
                continue
            (y1_dc, y1_ac), (y2_dc, y2_ac), (uv_dc, uv_ac) = dqm[seg]
            base = 384 * m
            if not is4:
                dc = [0] * 16
                nz = _coeffs(token_br, proba[1], tnz[8] + left_nz[8], y2_dc, y2_ac, 0, dc, 0)
                tnz[8] = left_nz[8] = int(nz > 0)
                _wht(dc, coeffs, base)
                first, bands = 1, proba[0]
            else:
                first, bands = 0, proba[3]
            for y in range(4):
                l = left_nz[y]
                for x in range(4):
                    nz = _coeffs(token_br, bands, l + tnz[x], y1_dc, y1_ac, first, coeffs, base + 16 * (4 * y + x))
                    l = tnz[x] = int(nz > first)
                left_nz[y] = l
            for ch in (4, 6):  # u, v
                for y in range(2):
                    l = left_nz[ch + y]
                    for x in range(2):
                        blk = base + 256 + 16 * ((ch - 4) * 2 + 2 * y + x)
                        nz = _coeffs(token_br, proba[2], l + tnz[ch + x], uv_dc, uv_ac, 0, coeffs, blk)
                        l = tnz[ch + x] = int(nz > 0)
                    left_nz[ch + y] = l
    f.coeffs = np.array(coeffs, dtype=np.int64).reshape(n_mb, 24, 4, 4)
    return f


def _wht(dc: List[int], out: List[int], base: int) -> None:
    """The inverse Walsh-Hadamard transform of the Y2 block into the DC of
    the 16 luma blocks."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        b = base + 64 * i
        out[b], out[b + 16], out[b + 32], out[b + 48] = (a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3


def _mul1(a: np.ndarray) -> np.ndarray:
    return ((a * 20091) >> 16) + a


def _mul2(a: np.ndarray) -> np.ndarray:
    return (a * 35468) >> 16


def inverse_dct(blocks: np.ndarray) -> np.ndarray:
    """(..., 4, 4) dequantized coefficients (raster order) -> the residual
    added to the prediction, (v + 4) >> 3 of libwebp's two passes."""
    x = blocks.astype(np.int64)
    a, b = x[..., 0, :] + x[..., 2, :], x[..., 0, :] - x[..., 2, :]
    c = _mul2(x[..., 1, :]) - _mul1(x[..., 3, :])
    d = _mul1(x[..., 1, :]) + _mul2(x[..., 3, :])
    v = np.stack([a + d, b + c, b - c, a - d], axis=-2)  # [row, column] after the vertical pass
    dc = v[..., 0] + 4
    a, b = dc + v[..., 2], dc - v[..., 2]
    c = _mul2(v[..., 1]) - _mul1(v[..., 3])
    d = _mul1(v[..., 1]) + _mul2(v[..., 3])
    return np.stack([a + d, b + c, b - c, a - d], axis=-1) >> 3


def _avg3(a: int, b: int, c: int) -> int:
    return (a + 2 * b + c + 2) >> 2


def _avg2(a: int, b: int) -> int:
    return (a + b + 1) >> 1


def _pred4(mode: int, top: List[int], left: List[int], tl: int) -> List[List[int]]:
    """A 4x4 prediction [row][column] from the 8 pixels above (4 and the 4
    above-right), the 4 to the left and the top-left."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == B_DC:
        v = (sum(top[:4]) + sum(left) + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == B_TM:
        return [[_clip(top[x] + left[y] - X, 255) for x in range(4)] for y in range(4)]
    if mode == B_VE:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [row[:] for _ in range(4)]
    if mode == B_HE:
        return [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))]
    d = [[0] * 4 for _ in range(4)]  # d[y][x]
    if mode == B_RD:
        vals = [_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I), _avg3(B, A, X), _avg3(C, B, A),
                _avg3(D, C, B)]
        for y in range(4):
            for x in range(4):
                d[y][x] = vals[3 - y + x]
    elif mode == B_LD:
        vals = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(E, F, G), _avg3(F, G, H),
                _avg3(G, H, H)]
        for y in range(4):
            for x in range(4):
                d[y][x] = vals[x + y]
    elif mode == B_VR:
        d[0] = [_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D)]
        d[1] = [_avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D)]
        d[2] = [_avg3(J, I, X), d[0][0], d[0][1], d[0][2]]
        d[3] = [_avg3(K, J, I), d[1][0], d[1][1], d[1][2]]
    elif mode == B_VL:
        d[0] = [_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)]
        d[1] = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F)]
        d[2] = [d[0][1], d[0][2], d[0][3], _avg3(E, F, G)]
        d[3] = [d[1][1], d[1][2], d[1][3], _avg3(F, G, H)]
    elif mode == B_HD:
        d[0] = [_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]
        d[1] = [_avg2(J, I), _avg3(J, I, X), d[0][0], d[0][1]]
        d[2] = [_avg2(K, J), _avg3(K, J, I), d[1][0], d[1][1]]
        d[3] = [_avg2(L, K), _avg3(L, K, J), d[2][0], d[2][1]]
    elif mode == B_HU:
        d[0] = [_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L)]
        d[1] = [_avg2(J, K), _avg3(J, K, L), _avg2(K, L), _avg3(K, L, L)]
        d[2] = [_avg2(K, L), _avg3(K, L, L), L, L]
        d[3] = [L, L, L, L]
    else:
        raise VP8Error(f"VP8: 4x4 mode {mode}")
    return d


def _pred_block(mode: int, top: np.ndarray, left: np.ndarray, tl: int, size: int, mb_x: int, mb_y: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction; DC without the top row or the
    left column where the frame has none."""
    if mode == DC_PRED:
        shift = size.bit_length() - 1  # log2(size)
        if mb_x and mb_y:
            v = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif mb_y:
            v = (int(top.sum()) + (size >> 1)) >> shift
        elif mb_x:
            v = (int(left.sum()) + (size >> 1)) >> shift
        else:
            v = 128
        return np.full((size, size), v, np.int64)
    if mode == TM_PRED:
        return np.clip(top[None, :] + left[:, None] - tl, 0, 255)
    if mode == V_PRED:
        return np.broadcast_to(top[None, :], (size, size))
    if mode == H_PRED:
        return np.broadcast_to(left[:, None], (size, size))
    raise VP8Error(f"VP8: prediction mode {mode}")


def _reconstruct(f: _Frame) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The unfiltered Y, U, V planes (whole macroblocks): each macroblock
    predicted from its reconstructed neighbours (127 above the frame, 129 to
    its left), plus its residual."""
    mb_w, mb_h = f.mb_w, f.mb_h
    res = inverse_dct(f.coeffs)  # (n_mb, 24, 4, 4)
    ys = np.zeros((16 * mb_h, 16 * mb_w), np.int64)
    us = np.zeros((2, 8 * mb_h, 8 * mb_w), np.int64)  # u, v
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            m = mb_y * mb_w + mb_x
            y0, x0 = 16 * mb_y, 16 * mb_x
            r = res[m]
            if mb_y:
                top = ys[y0 - 1, x0:x0 + 16]
                tl = int(ys[y0 - 1, x0 - 1]) if mb_x else 129
            else:
                top = np.full(16, 127, np.int64)
                tl = 127
            left = ys[y0:y0 + 16, x0 - 1] if mb_x else np.full(16, 129, np.int64)
            if f.is4[m]:
                if not mb_y:
                    tr = [127] * 4
                elif mb_x == mb_w - 1:
                    tr = [int(ys[y0 - 1, x0 + 15])] * 4
                else:
                    tr = ys[y0 - 1, x0 + 16:x0 + 20].tolist()
                work = [[0] * 21 for _ in range(17)]  # the top row, the left column, the 16x16 block
                work[0][0] = tl
                work[0][1:17] = top.tolist()
                work[0][17:21] = tr
                for k in (4, 8, 12):
                    work[k][17:21] = tr
                lv = left.tolist()
                for k in range(16):
                    work[k + 1][0] = lv[k]
                modes = f.imodes[m]
                rl = r[:16].tolist()
                for n in range(16):
                    by, bx = 4 * (n >> 2), 4 * (n & 3)
                    above = work[by][bx + 1:bx + 9]
                    lft = [work[by + 1 + k][bx] for k in range(4)]
                    pred = _pred4(modes[n], above, lft, work[by][bx])
                    rn = rl[n]
                    for yy in range(4):
                        row, prow, rrow = work[by + 1 + yy], pred[yy], rn[yy]
                        for xx in range(4):
                            v = prow[xx] + rrow[xx]
                            row[bx + 1 + xx] = 0 if v < 0 else 255 if v > 255 else v
                ys[y0:y0 + 16, x0:x0 + 16] = np.array(work, np.int64)[1:, 1:17]
            else:
                pred = _pred_block(f.ymode[m], top, left, tl, 16, mb_x, mb_y)
                resid = r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
                ys[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + resid, 0, 255)
            cy, cx = 8 * mb_y, 8 * mb_x
            for c in range(2):
                plane = us[c]
                if mb_y:
                    ctop = plane[cy - 1, cx:cx + 8]
                    ctl = int(plane[cy - 1, cx - 1]) if mb_x else 129
                else:
                    ctop, ctl = np.full(8, 127, np.int64), 127
                cleft = plane[cy:cy + 8, cx - 1] if mb_x else np.full(8, 129, np.int64)
                pred = _pred_block(f.uvmode[m], ctop, cleft, ctl, 8, mb_x, mb_y)
                resid = r[16 + 4 * c:20 + 4 * c].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
                plane[cy:cy + 8, cx:cx + 8] = np.clip(pred + resid, 0, 255)
    return ys, us[0], us[1]


# ---------------------------------------------------------------- loop filter


def _filter(seg: np.ndarray, thresh: int, ithresh: int, hev_t: int, kind: str) -> None:
    """Filter each line of `seg` (N, 8) = p3 p2 p1 p0 q0 q1 q2 q3 across the
    edge between p0 and q0, in place: kind "simple", "mb" (6 taps where
    not high edge variance) or "inner" (4 taps)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (seg[:, i] for i in range(8))
    thresh2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= thresh2
    if kind != "simple":
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
            mask &= np.abs(a - b) <= ithresh
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    else:
        hev = np.ones_like(mask)
    if not mask.any():
        return
    # Two taps (hev, or the simple filter).
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
    two = mask & hev
    new_p0 = np.where(two, np.clip(p0 + a2, 0, 255), p0)
    new_q0 = np.where(two, np.clip(q0 - a1, 0, 255), q0)
    new_p1, new_q1, new_p2, new_q2 = p1, q1, p2, q2
    rest = mask & ~hev
    if kind == "inner" and rest.any():
        a = 3 * (q0 - p0)
        a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        new_p1 = np.where(rest, np.clip(p1 + a3, 0, 255), p1)
        new_p0 = np.where(rest, np.clip(p0 + a2, 0, 255), new_p0)
        new_q0 = np.where(rest, np.clip(q0 - a1, 0, 255), new_q0)
        new_q1 = np.where(rest, np.clip(q1 - a3, 0, 255), q1)
    elif kind == "mb" and rest.any():
        w = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1, a2, a3 = (27 * w + 63) >> 7, (18 * w + 63) >> 7, (9 * w + 63) >> 7
        new_p2 = np.where(rest, np.clip(p2 + a3, 0, 255), p2)
        new_p1 = np.where(rest, np.clip(p1 + a2, 0, 255), p1)
        new_p0 = np.where(rest, np.clip(p0 + a1, 0, 255), new_p0)
        new_q0 = np.where(rest, np.clip(q0 - a1, 0, 255), new_q0)
        new_q1 = np.where(rest, np.clip(q1 - a2, 0, 255), q1)
        new_q2 = np.where(rest, np.clip(q2 - a3, 0, 255), q2)
    seg[:, 1], seg[:, 2], seg[:, 3] = new_p2, new_p1, new_p0
    seg[:, 4], seg[:, 5], seg[:, 6] = new_q0, new_q1, new_q2


def _edge_step(plane: np.ndarray, ys: np.ndarray, xs: np.ndarray, n: int, vertical: bool, params, kind: str) -> None:
    """One edge of each listed macroblock at once, in place: the vertical
    edge left of column xs (over rows ys .. ys + n; libwebp's HFilter), or
    the horizontal edge above row ys (over columns xs .. xs + n; VFilter).
    params: per macroblock (thresh, interior limit, hev threshold)."""
    if not len(ys):
        return
    along = np.arange(n)
    across = np.arange(-4, 4)
    if vertical:
        rows = (ys[:, None] + along[None, :]).reshape(-1, 1)
        cols = np.repeat(xs, n)[:, None] + across[None, :]
    else:
        rows = np.repeat(ys, n)[:, None] + across[None, :]
        cols = (xs[:, None] + along[None, :]).reshape(-1, 1)
    rows, cols = np.broadcast_arrays(rows, cols)
    seg = plane[rows, cols]
    _filter(seg, *(np.repeat(p, n) for p in params), kind)
    plane[rows, cols] = seg


def _loop_filter(f: _Frame, ys: np.ndarray, us: np.ndarray, vs: np.ndarray) -> None:
    """Every macroblock's edges in raster order: left edge, inner vertical
    edges, top edge, inner horizontal edges (luma; with the normal filter
    chroma too). Macroblock (x, y) reads what (x - 1, y), (x, y - 1) and
    (x + 1, y - 1) wrote and touches nothing of (x + 2, y - 1), so the
    macroblocks of one wavefront x + 2 y are filtered together, each edge of
    theirs in its raster order, with the same result."""
    if not f.filter_type:
        return
    n_mb = f.mb_w * f.mb_h
    mb_x = np.tile(np.arange(f.mb_w), f.mb_h)
    mb_y = np.repeat(np.arange(f.mb_h), f.mb_w)
    strength = np.array([f.fstrengths[s][int(i4)] for s, i4 in zip(f.segment, f.is4)], np.int64).reshape(n_mb, 3)
    limit, ilevel, hev_t = strength.T
    # Inner edges are filtered in 4x4-mode macroblocks and in those with a
    # non-zero coefficient (after the WHT): libwebp's f_inner_.
    inner = np.asarray(f.is4, bool) | f.coeffs.reshape(n_mb, -1).any(axis=1)
    active = limit > 0
    front = mb_x + 2 * mb_y
    cw = us.shape[1]
    uv = np.concatenate([us, vs], axis=1)  # u and v side by side: one gather for both
    simple = f.filter_type == 1
    for t in range(int(front.max()) + 1):
        on = np.flatnonzero((front == t) & active)
        if not len(on):
            continue
        left, top, inn = on[mb_x[on] > 0], on[mb_y[on] > 0], on[inner[on]]

        def params(sel, extra):
            return limit[sel] + extra, ilevel[sel], hev_t[sel]

        steps = [(left, 0, True, 4, "mb"), *((inn, k, True, 0, "inner") for k in (4, 8, 12)),
                 (top, 0, False, 4, "mb"), *((inn, k, False, 0, "inner") for k in (4, 8, 12))]
        for sel, k, vertical, extra, kind in steps:
            kind = "simple" if simple else kind
            y0, x0 = 16 * mb_y[sel], 16 * mb_x[sel]
            _edge_step(ys, y0 + (0 if vertical else k), x0 + (k if vertical else 0), 16, vertical,
                       params(sel, extra), kind)
            if simple or k == 8 or k == 12:
                continue
            cy, cx = 8 * mb_y[sel], 8 * mb_x[sel]
            both = np.concatenate([sel, sel])
            cy2, cx2 = np.concatenate([cy, cy]), np.concatenate([cx, cx + cw])
            _edge_step(uv, cy2 + (0 if vertical else k), cx2 + (k if vertical else 0), 8, vertical,
                       params(both, extra), kind)
    us[:] = uv[:, :cw]
    vs[:] = uv[:, cw:]


# ---------------------------------------------------------------- YUV -> RGB


def _upsample(c: np.ndarray, height: int, width: int) -> np.ndarray:
    """libwebp's fancy upsampler: a chroma plane ((H + 1) / 2, (W + 1) / 2)
    -> (H, W), each pixel from its nearest chroma sample (weight 9/16), the
    two beside it (3/16 each) and the diagonal one (1/16), in libwebp's
    integer steps; edges replicate."""
    c = c.astype(np.int64)
    hc = c.shape[0]
    y = np.arange(height)
    near_row = np.where(y % 2 == 1, (y - 1) // 2, y // 2)
    far_row = np.where(y % 2 == 1, (y + 1) // 2, y // 2 - 1)
    near = c[np.clip(near_row, 0, hc - 1)]
    far = c[np.clip(far_row, 0, hc - 1)]
    out = np.empty((height, width), np.int64)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    if width % 2 == 0:
        j = (width - 1) >> 1
        out[:, width - 1] = (3 * near[:, j] + far[:, j] + 2) >> 2
    m = np.arange(1, (width - 1) // 2 + 1)  # interior pairs 2m - 1, 2m
    if len(m):
        a, b, cc, d = near[:, m - 1], near[:, m], far[:, m - 1], far[:, m]
        out[:, 2 * m - 1] = (((a + 3 * b + 3 * cc + d + 8) >> 3) + a) >> 1
        out[:, 2 * m] = (((3 * a + b + cc + 3 * d + 8) >> 3) + b) >> 1
    return out


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.clip(v >> 6, 0, 255)


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's fixed-point BT.601 conversion of full-size planes -> (H, W, 3) uint8."""
    y, u, v = (p.astype(np.int64) for p in (y, u, v))
    yy = (y * 19077) >> 8
    r = _clip8(yy + ((v * 26149) >> 8) - 14234)
    g = _clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = _clip8(yy + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def decode_vp8(data: bytes) -> np.ndarray:
    """A VP8 key frame -> (H, W, 3) uint8 RGB, as libwebp's default decode
    into RGB(A) gives it: the filtered planes cropped to the frame, chroma
    upsampled, converted."""
    f = _parse(data)
    ys, us, vs = _reconstruct(f)
    _loop_filter(f, ys, us, vs)
    h, w = f.height, f.width
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return yuv_to_rgb(ys[:h, :w], _upsample(us[:ch, :cw], h, w), _upsample(vs[:ch, :cw], h, w))


def frame_size(data: bytes) -> Tuple[int, int]:
    """(width, height) of a VP8 key frame."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        raise VP8Error("VP8: bad start code")
    return (data[6] | data[7] << 8) & 0x3FFF, (data[8] | data[9] << 8) & 0x3FFF

"""Glyphs of cv2.putText(FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1) as
OpenCV 5.0 renders them: per printable ASCII character its pen advance, the
offset of its bounding box from the text origin (baseline left), and its
anti-aliased coverage bitmap (0-255), recovered from cv2's own rendering of
each glyph white on black. Written by `python -m tests.test_torch_visualizers`
(the test holds it to a fresh recovery); used by visualizers/raster.put_text.
"""
import base64
import functools
import zlib

import numpy as np

# (character code, advance, x offset, y offset, height, width); the coverage
# bytes of all glyphs, row-major, follow one another in _DATA in this order.
_METRICS = (
    (32, 3, 0, 0, 0, 0),
    (33, 3, 1, -11, 11, 2),
    (34, 5, 0, -11, 4, 5),
    (35, 10, 0, -10, 10, 10),
    (36, 9, 0, -12, 14, 9),
    (37, 11, 0, -11, 12, 11),
    (38, 10, 0, -11, 12, 10),
    (39, 3, 0, -11, 4, 3),
    (40, 9, 2, -13, 15, 5),
    (41, 9, 2, -13, 15, 5),
    (42, 6, 0, -11, 5, 6),
    (43, 9, 0, -9, 9, 9),
    (44, 3, 0, -2, 4, 3),
    (45, 7, 1, -6, 3, 6),
    (46, 3, 1, -2, 2, 2),
    (47, 7, 0, -12, 14, 7),
    (48, 9, 0, -11, 12, 9),
    (49, 9, 1, -11, 11, 8),
    (50, 9, 0, -11, 11, 9),
    (51, 9, 0, -11, 12, 9),
    (52, 9, 0, -11, 11, 9),
    (53, 9, 0, -11, 12, 9),
    (54, 9, 0, -11, 12, 9),
    (55, 9, 1, -11, 11, 8),
    (56, 9, 0, -11, 12, 9),
    (57, 9, 0, -11, 11, 9),
    (58, 3, 1, -7, 7, 2),
    (59, 4, 0, -7, 9, 3),
    (60, 7, 0, -9, 9, 7),
    (61, 8, 1, -7, 5, 7),
    (62, 7, 1, -9, 9, 6),
    (63, 7, 0, -11, 11, 8),
    (64, 12, 0, -10, 12, 12),
    (65, 10, 0, -11, 11, 10),
    (66, 10, 1, -11, 11, 9),
    (67, 9, 0, -11, 12, 10),
    (68, 10, 1, -11, 11, 9),
    (69, 9, 1, -11, 11, 8),
    (70, 8, 1, -11, 11, 8),
    (71, 10, 0, -11, 12, 10),
    (72, 10, 1, -11, 11, 9),
    (73, 4, 1, -11, 11, 2),
    (74, 9, 0, -11, 12, 9),
    (75, 9, 1, -11, 11, 8),
    (76, 8, 1, -11, 11, 8),
    (77, 11, 1, -11, 11, 10),
    (78, 10, 1, -11, 11, 9),
    (79, 10, 0, -11, 12, 10),
    (80, 9, 1, -11, 11, 9),
    (81, 10, 0, -11, 12, 10),
    (82, 9, 1, -11, 11, 9),
    (83, 9, 0, -11, 12, 9),
    (84, 8, 0, -11, 11, 9),
    (85, 10, 1, -11, 12, 9),
    (86, 9, 0, -11, 11, 10),
    (87, 11, 0, -11, 11, 12),
    (88, 9, 0, -11, 11, 10),
    (89, 9, 0, -11, 11, 10),
    (90, 8, 0, -11, 11, 9),
    (91, 4, 1, -12, 15, 4),
    (92, 7, 0, -12, 14, 7),
    (93, 4, 0, -12, 15, 4),
    (94, 6, 1, -11, 3, 5),
    (95, 11, 0, -1, 2, 11),
    (96, 5, 1, -11, 3, 4),
    (97, 8, 0, -8, 9, 8),
    (98, 8, 1, -11, 12, 8),
    (99, 8, 0, -8, 9, 8),
    (100, 8, 0, -11, 12, 8),
    (101, 8, 0, -8, 9, 8),
    (102, 5, 0, -12, 12, 6),
    (103, 8, 0, -8, 12, 8),
    (104, 9, 1, -11, 11, 8),
    (105, 3, 0, -11, 11, 3),
    (106, 3, -1, -11, 14, 4),
    (107, 7, 1, -11, 11, 7),
    (108, 3, 1, -11, 11, 2),
    (109, 13, 1, -8, 8, 12),
    (110, 9, 1, -8, 8, 8),
    (111, 8, 0, -8, 9, 8),
    (112, 8, 1, -8, 11, 8),
    (113, 8, 0, -8, 11, 8),
    (114, 5, 1, -8, 8, 5),
    (115, 7, 0, -8, 9, 7),
    (116, 5, 0, -11, 11, 6),
    (117, 9, 1, -8, 9, 7),
    (118, 8, 0, -8, 8, 8),
    (119, 12, 0, -8, 8, 12),
    (120, 8, 0, -8, 8, 8),
    (121, 8, 0, -8, 11, 8),
    (122, 7, 0, -8, 8, 8),
    (123, 5, 0, -12, 15, 6),
    (124, 3, 1, -14, 18, 2),
    (125, 5, 0, -12, 15, 6),
    (126, 8, 1, -6, 3, 7),
)
_DATA = (
    "eNqlWQdYVMe3Pwu79KIISrOBFQvY0ASDGrsRUcBKwIqKxq5/BEQRVMSo2Iixgb2AYkFXEnsjqzQFERSRRaRJ7yxb5p2ZWXx55ku+"
    "vO8/6D1n786dO6f/zux8x/ehf/7zdTq+oPGE2clvt6y2INOfxGrKv4s9CIc7zJsKAO77QCexPTJw8Bj0k2sB7IsrzIp71hS3ApYG"
    "N5wJfvwmeAqAnsoOTu+j0+wV2iBZBjBIWqKUSuWfpUMNXc49n+JNvKcYAUQdgGGNGnTe2B5gSV+AQ7N2EKMGi8mhXkjdaosTSsgG"
    "gLR7AIJjqs76is1423ChOdytWdOOzz1S2xI/U4uy+rOvKZ+350sNV60Z/9kOGZPG7UYlbz36ut+QO4JNfD1RJI1jk8kYPlOwsQMl"
    "pr4zdJCYr9XUkEbdvQAgfBgN3+ZAh2YdCMvQg3FpoEeMJtXgvvSLx6991Kl8Nn1s1Jn9/f44rOUoYmtFpAwpSSruSbdeZRsRBrt3"
    "AdhWTYPLy2HlJdBJ3Quw+ShE+0HQY3zA4m75b6agHkwCI98DCxmjlZIfXXyDciNJbxhNrJBzIPYwX6ZPt3w9c1vzUvbYEqJyAXAZ"
    "Af+RbcqStIHCjbqyzdAhI2mqyq69yg3lSlNeBHiePszKs0j+0hTa324mZXs6JiXTt5izNdDiaG+0NtqaarQLwI6WKzBV4S6Es+fw"
    "ThGaUaCcgPsj3wFYkcH4DPkGQJt8j982ueNFsg0vIW9QhZYFifjanuGbzehiK1S/4z2HIuoSSz/ipR/phl5C1xEocedQ9yNemqej"
    "vslYgPZkCMD4FgOAU4/APrZlDEw7wuw0rUQLRFfXSVcFmcbkkcQQcKxIvG8Aky7b3mcWX9VBrcf6UX9mRFZWVg3TrawMPQkfZwUG"
    "BgYNkwwMRH+dTMc6C3o9F6an8rWvbyM0AzNcwVLQSJ8dYG1ra2uj8fuexrtsrucBetV4t46S8Y0mlNw4Qa9dFMyRd/5BrzplXpR4"
    "f9am5HkYvQ5WdKYk+jq9tmtkHrn+rYASGxv1ViyWH/Lrj3RAieoJIaimB4V2cJyUG+qrjoHOh6VkXB/iCV6/WJJlg8kUkPQ1ImsG"
    "kqmDH4IxWW1NNkTNgCHES1CZ+l4Em8kACCXEObTqMSrlFCHN182Y81tyx9VZMZntO5lcoyFZkZpD6YojOonX+Gb+Fe3j4pIlcXFp"
    "d5rregY6zPJDq2gUWuRWiiua0IOOVnQGrYyXALd34u2wFpYCQONpOo/FAyq2D40oFXNvjZOqZWq6kk04Tm674DDQbuGvcAKPQDqW"
    "ABxKTU1NJ1l8nZNVfRnzc/MIRjcop3M5laTsZg/Kdeo+M7nCkG9+LJnUNQn9GWaS0aL376b0WZRTqAU2N+SkIcGaThBZa6qNIpjn"
    "xzW2lBCmwV4NtxijlRI7kzHhn0wYM0oxFijT9mMEMCaYpDx79pa8+sV5C44rZJcn9yK+DmZYRRsAY38qjgfACJKOAh2kj+ry71dX"
    "qfewszD81imMMThJrvnHqtALO/fBT0GkJzB19iceRvK1yMzGOzer5/aaU47Rrn+mitTGGjMhvohjvrEzz7wPcrkuAuXDGB0m38yo"
    "US5pkR7FVLubRE9bVZahrV1zHm9/S7w6kcXUMo07BJ8PU9ujubcqgxwmv8tCMQLfk5p4S7aCKX3XLGalDZonM3FUqPTYNy/vMOKM"
    "zkvH5Vy2+05s6+gbdW0o0S3/hX1cqOrNH/qNEXuajujo+tOhjY5Iv69+eypRuRog4Slm0F1VQsikD85UmcLW2kW9XHMfoHKL0WVU"
    "KGBS/jRrp0eVVr0IrTztFUscWhnhq/wpFsMe1llBp8ty0pxIFQtCa27zjqsi13en/lJderuwcQYIPyYagLa4qk1v4sncaExXphRX"
    "4ixIfmcDlqlF2tAzQ/VJyb7X+sZPeYH7+x0pEw7WK75j1Kp5CyXl98UHuFjX9tQ9gbtlsP8WfBnBsZD9qxDLGMtRIApypv6XVNkf"
    "BCsbb1tBhzt1SzCF/ERYvtE7qghnGeeHoowBLM3EtDixB2cNeFtLh8+A4XS0Uy/fezAdbfJb6Fh6piO997CKrqXp13yFOmm/1BKa"
    "qaxKngJMLU3tbXxSHqoF77OH4s0AblOYuDPCS4jpW/X8N/kT4USynLrhD7OvowYHEBdW2+7ksSIWWz2A+z83/5mPfAHPZZz+x5/T"
    "pFecetzMLXp6gPqU4MKH5Y52M36tx8qwNMsS9PQ0NJYVGkHaAggsrU8LFRRPMJGbWJb07v5pJ5z371kFCy9jTt8Je8N7VMPMSwBx"
    "++FwsEFTz7ZVo1wqct2kE+HWCZj6LPfHHU824X5lduyNE2h1+0mR5O/qm1BM0wMM2XDhbvRifZ4Jfloh4DtzIoRnGTie/uokY/Rr"
    "16yuN6LcvBYzM9kiyj2KA7jyDJlutGRPJogktpPYCxdiSThoFiRH4UguQo05sgJBXI6n8UWTT7pi7Pi7o+jiyjt3njTXjQTxI1qo"
    "855xBs6VgPiJrq7J9IZoELPEWNIWxEl2dvbrKi6q54TKjDkTJjcWpzo6Om2pugpxNCDeHaYZRm/C1ojF1Cv1n5J3T2Ul3wIcUaKH"
    "mRR9FIL0AX3yR9LXjKzmzgcdiY/acay/cDrNDPqZbzKHp0U07s8Qc8xrN9yGh6qoYuakyEllKM9n+iztUdEWDUI/FdelptaSfBu2"
    "W+2Jue/V295CunLGgbhzxpp4c6YT8eLMd8SZM1uVhuL0cePm7FceZqJVPAzSYK9A/RmJazChpiZ3FPMMAn+hslIcd0H80gOH81+/"
    "Tx6HY6xBHC89o/m6flrieprU0tuI76nnfU0/X8MRCuLC4zg2wN/Ni/sS6trjtuxbTOGE3l2Sc7e6DP0wUomJwvRFuR58uE+n9Nlr"
    "0Y6saUUKxBdLHL5kiDnlPEL2E0+d5gj6lSMZDY+KMSBhU4s+uMmveQwOVOzBj9NT5arsTfx5vbbMFB4sOv26c12ak7n/xCibcciQ"
    "yZ6LY+U/To5jGmynmOk6Uyz5+i/uIfgwTQZYQPwrHDlkPN/W0H/HdHKjdcOdDHFFWbEoNmm1LXrnMuRQYySWwocqUhjB6ooey5qu"
    "tG5a+fWnSrfJSzZB2vsT4mbxPYfSpxiw4rzKhwbUKKSyDTdeS5yIGWma7IqIGWtK82URM9qkphghM9r4mgjX6WpjPv0v6RuKbyZp"
    "cCdTmE6Zw+8vdRYr+nCsEikmcTT/vEBOqsRs4dZYGim+dfkOaGbuzkSuj/J771ozysHZ5x+2AeO6y6vacg5moO44R0dm5JU4zqXu"
    "4VJ0QZ9W0Cw0nXQQkwwtzmQ1beHMLT9ZX84IX0g0GQP9ZGs5A5sbNnJG9LKOMzBQTjrEXWE5SIFerfNDyM5pFG0Y3G+RPGp8icg9"
    "sm44VrKSmwBZ51mKqhUaqxgMcCf9LVhNhTHEyZwsYVCbDBM1HKFcALGE++W0Y8r4gNlFmeAx8SLxw49eWUpV7gYulkHb1kSzbhy1"
    "cG1i4hvy0Z6r3Eb6RK37HS3anBF/BHG2h8eiWEUIiFtKS/MT8K1iiTrW/sqgA7eOr0RLa/9FtOtfRKv5t6J1bRWtRtAq2ia1aFIO"
    "j6lo4eXGVLSlXeiWahITc0i6KU+dPer81Dn0fBZnND7Eg/iDn9/u101TUA8vXpTUYxGiX32jmsMZOFugzxnr+m3AA3djA4ZCrxWR"
    "m2hTM6OxNKFIia7w4akABAdVfbRlO2h0LbSCm3XreTurF1nTcmuODmNnXlGkcLwCjkr/EWUOFFTW/qxd+H5GX7crSiewiq8m8sxx"
    "vBuhgGVMIB+WIbm5ZSQvN9eRwe026kD475h5chrdcyZS3tjfMiWGgUky4f/FXMtgMIr0DSQUDl6q07Srerls1NHmQwCDkppbM44W"
    "60yH8s7FeKO1K22cAXwVFtpVuxkiwCRy4iPOtVb6UC/AFL9WhhGiWYyp68VNOuVAqbAbA4/wDRkX2MBAuiAv+nUMFyesiUzjXB9Z"
    "MVV4t/Xa/LPuhq7fkOGc/54M0pPjNkwR6q2XaUM61uI3CKsupGC6TIdeBH3t7VHs9+S6/0nJWGWkXEIR/tBnAVvvjaANub5ii7Kn"
    "fUtIC137dSVKn1OZShc+RYKx4SHHKO/TYkdDfS7ivI0M+YxfBl1rzlCI2rgLFU9mgSgpna5wpbJjSLM96w2KX8r9+B5/JK95U6Jx"
    "X6EYrm7afkjNow2Lg2w39lnnUKjMVIyIxaiQIHoQAxBbpffdcgbDLAPaMSfG5d9rwymEgxhMiLMsaveA9lsxW6+lb4CMNX9ab5Ma"
    "dqrxKik0UEfv54OtcVy6/69c/i5WzQJ4rTJxoKXqVRVhGBa61d5ku9BKKuLd3B7lWEYnqX5m1PJzMjvY0bhXx3YAm8h8RgfKWcZ3"
    "MfVWn1DMDo+KGlmWeGxE2QqAf/2/QjrXbf787itC2KJjZOw4RJAVwD6uzGeqNa7j52y//s5IPxXfyWOG2WBmFcO1oiIO5rZy9Gkl"
    "/5bR2LOMtLefERW1ZvqxDMSxEf/6f5C05tnA+fNHw5pYCwjMPv6mg6seONrqR51Ujx5/Yu++twb9y0moToyEtoeyci/ZANzKdp3y"
    "R7YQJllhP0PQ0XoGX8shQ+HipwMe3mTocAXO8SFDR5LpQsdPZKhga4OybLPSgR4AUdG3T+Y2lIZ9RSN2Zb5CiCiVX/cMV4aANBVn"
    "R1ZrSPey/NxRGg4UqdtK7zEAJZKSjV0mV5+F7IMSlTKBJbs2zHs0Ap7k30ZNHardPet32QDtRnQbw6T1Q9gBGe0QvuHdtBwzuEbE"
    "LLidN7XjDuIORjcaSbUfP2IQtnqat7pwnZZ8oVo/v0kLPCeBE42bvR/IJW0VaFi9AskwQju6SxJnllnOSqzIAmp1CTwoGGW7l0ig"
    "0zOVIuHswy/7hDWPs3/FUrGt0nt0fFZbUR1Gum6Vz1Cyb+3atflHhpOYSBxzhYX0VE5XE3ZI++v4yN3AZPMHZTlD/hoW6q7HGGH8"
    "1HxyCQQVV+yMEeZhsO1KI1mShWMDyH5fB2wQKBz7u6s5C3Lt3W/SglYehuONW7zuNycbyVEu/U/Jg5lcF5KHsmbodLKpCmGtZk4y"
    "xH+e7hhNksHsen312cvJGu5mmhpw+7Kw9Jo2ONSsgrHFzSWKM5hRtfsNR4G3T2u181f04I70tGC0u+zuglMt20BKm5UbUpAepR0f"
    "MWTz5hOTr2k29Zs5ciPBzeWCO0wdMZ5QEPz1v/do0SOYLk7yyILdQQD3Yv7+v+RYd3/FPN/HGwXbOayVBn9FNHc8NpIGG4vLRoD0"
    "dGamLd4kL2lqlBYqvNmUEFpCcKafcgVk4/uXt7hvnyQN/fovOzBmydm8hP694z5csoACZbjn66IC/7n5KVBwg3adWMGmEquC7eiQ"
    "KvQNWzKmgG5CNZ/abfzf8VRgaJxDrToiZu6ujJRNAihoSph/Fv20QIoOk5AJBTS7rlYKC6gOfYj21/Q9PQHxlolAsO5B7jn05921"
    "u2bfqeqn1YBa1K3dM5CMpHkocZjaJwxZLBWegJtS105hyklgeLWefFjIzmtoDr4wb++b9BBsXZtpbIeDNF1I0ZiGdB+L7c7SnSy2"
    "u0lv09iWa0mJX+fJ1RdRv0+Uyt/MaI4wNvhTrri1rBXkRWS9DF4ZCSebg73vN0va0N8kMBYd2SHARYkToSdo0RKO7VIl8KhwtM1O"
    "jMUuiSqF+JqEx2KUOrZb6ebTMfPCHnoVNCWHORXQ2lpA6wbTzf9emIrAJiYvbZNII1880v3TdnN6MGzSHuJlsfMR5wonHP8om8dO"
    "9M6XOtfP0LSQpMD6ihZlMjYPAgt6RmMVRQ98hpHerdddr8kryfdjd5Gtvp3/fF99tWfy6DbHOqFWZ79VBfxGz/sXXGpaT48iC/4v"
    "aaSO8HNBJu0okgsO1fv02EQK9OJlqj8O5WBkU4/1vk4TSMDBAWQUzT0b4AViBC+ZGSxsNIYHl3BWzdJuKpoifnmxI0fAOv8aDhIe"
    "VGNZm0J/FgkLRXFuTrYn/UC3vkYbBiKT5w+uxWWTIAhbgf3PIPrw8eMgQWOPVpiXj5342VKJuVhUFV0h0qqKrqTJ9jw9kzijYpVt"
    "mmICFmuFK8DIJz0BOtybLHycoad5L1UHrEpPbau2pa2XUsXyyUiFgqZ18+JLZ0qtQPPBG0O99Gei5dVYlrpXbvCKpxVnzYn+NCHq"
    "VQTCQ3QwnyYzcFd2g1dRaKOPu50JhcH+FfGsdTBtIm7cxaS8TtfyArCqvi0/GQulVzsJHfuhna+v7wHCYIlRdgrFfIKrFV1Zy6Bk"
    "sHa8grlJ54pXA+zt7YDjCjkWd8GcCMSPEU1XDUG/3pf9FtOT/cJE8blPA76708erDJrQQ0ndRy/ZcRw7rHUi9By8F6G/RwhL9lJ4"
    "u0BZRAugjZvWrE7FXv/0V+hpJprp340eSL8tpzsVFQcxTBFLr0fZeca2T+woWMVOJMR1KJaLkqKVbW9ZlLA+5DptoDrW/4Q7VKSh"
    "agY505MkU4/xRtCxQ051szyvZdQoDa0Ri5zgfwDbkr86"
)


@functools.lru_cache(maxsize=None)
def glyphs():
    """{character: (advance, x offset, y offset, (h, w) uint8 coverage)}."""
    raw = np.frombuffer(zlib.decompress(base64.b64decode("".join(_DATA))), np.uint8)
    out, at = {}, 0
    for code, adv, ox, oy, h, w in _METRICS:
        out[chr(code)] = (adv, ox, oy, raw[at:at + h * w].reshape(h, w))
        at += h * w
    assert at == raw.size
    return out

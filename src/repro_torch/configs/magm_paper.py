"""The paper's own experimental configuration (section 6).

Theta_1 is from Kim & Leskovec (2010), Theta_2 from Moreno & Neville (2009);
mu = 0.5 and d = log2(n) is the paper's main-line setting.
"""

import numpy as np

THETA_1 = np.array([[0.15, 0.70], [0.70, 0.85]], dtype=np.float32)
THETA_2 = np.array([[0.35, 0.52], [0.52, 0.95]], dtype=np.float32)
DEFAULT_MU = 0.5

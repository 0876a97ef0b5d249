from .context import CKKSContext
from .ciphertext import Ciphertext, Plaintext
from .encoding import Encoder
from .keys import KeyChest
from .ops import Evaluator

__all__ = [
    "CKKSContext", "Ciphertext", "Plaintext", "Encoder", "KeyChest",
    "Evaluator",
]

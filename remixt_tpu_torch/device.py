"""Device resolution and dtype policy.

Entry points take ``device=None``, which means CUDA. Without a CUDA device
they raise instead of carrying on on the CPU; callers that want the CPU (the
tests) ask for it explicitly.

dtype policy: float32 or float64, whichever the caller asks for, float32
by default. The hand-written kernels are float32; a float64 engine on the
card runs the plain chain scan of ``ops/fb_scan.py`` instead, as the JAX
package's float64 engine runs its XLA scan. TF32 is off for both matmuls
and convolutions: every accuracy figure of the reference was taken at full
float32 precision.
"""

import torch

DTYPES = {'float32': torch.float32, 'float64': torch.float64}


def resolve_device(device=None):
    """``None`` → ``cuda``. Raises when a CUDA device is asked for and
    none is available."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run on '
                'the CPU')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != 'cpu':
        raise ValueError('unsupported device {}'.format(device))
    return device


def resolve_dtype(dtype='float32'):
    """Engine dtype: the caller's choice, a name or a torch dtype, float32
    or float64."""
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]
    if dtype not in (torch.float32, torch.float64):
        raise ValueError('unsupported engine dtype {}'.format(dtype))
    return dtype

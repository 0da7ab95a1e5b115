"""baseband_tasks_tpu: radio-baseband reduction on JAX/XLA.

A from-scratch JAX/XLA re-design with the capabilities of
mhvk/baseband-tasks: streaming task pipelines (channelization, coherent and
incoherent dedispersion, polyphase filter banks and inversion, resampling,
pulsar folding and phase computation), device-resident and jit-compiled,
with sharding over device meshes.  Its accelerator is an NVIDIA GPU
(H100).
"""

__version__ = "0.2.2"

from .base import (Base, BaseTaskBase, TaskBase, PaddedTaskBase, Task,
                   SetAttribute)
from .generators import (StreamGenerator, EmptyStreamGenerator, Noise,
                         NoiseGenerator)
from .channelize import Channelize, Dechannelize
from .functions import Square, Power
from .integration import Integrate, Fold, PulseStack
from .convolution import Convolve, ConvolveSamples
from .shaping import (ChangeSampleShape, Reshape, Transpose,
                      ReshapeAndTranspose, GetItem, GetSlice)
from .combining import CombineStreams, Concatenate, Stack
from .sampling import ShiftAndResample, Resample, TimeDelay, ShiftSamples
from .dm import DispersionMeasure
from .conversion import Real2Complex
from .registry import open
from .pfb import (sinc_hamming, PolyphaseFilterBank,
                  PolyphaseFilterBankSamples, InversePolyphaseFilterBank)
from .dispersion import (Disperse, Dedisperse, DisperseSamples,
                         DedisperseSamples)
from .faraday import FaradayRotate, DeFaraday
from .polarization import ConvertPolarization, ApplyJones
from .rfi import SpectralKurtosis, ExciseSpectralKurtosis
from .timing import ProfileTemplate, fit_phase_shift

__all__ = ["Base", "BaseTaskBase", "TaskBase", "PaddedTaskBase", "Task",
           "SetAttribute", "StreamGenerator", "EmptyStreamGenerator",
           "Noise", "NoiseGenerator", "Channelize", "Dechannelize",
           "Square", "Power", "Integrate", "Fold", "PulseStack",
           "ChangeSampleShape", "Reshape", "Transpose", "ReshapeAndTranspose",
           "GetItem", "GetSlice", "CombineStreams", "Concatenate", "Stack",
           "Convolve", "ConvolveSamples", "ShiftAndResample", "Resample",
           "TimeDelay", "ShiftSamples", "DispersionMeasure", "Disperse",
           "Dedisperse", "DisperseSamples", "DedisperseSamples",
           "Real2Complex", "sinc_hamming", "PolyphaseFilterBank",
           "PolyphaseFilterBankSamples", "InversePolyphaseFilterBank",
           "SpectralKurtosis", "ExciseSpectralKurtosis",
           "FaradayRotate", "DeFaraday",
           "ConvertPolarization", "ApplyJones",
           "ProfileTemplate", "fit_phase_shift", "open"]

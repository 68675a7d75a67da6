"""The attention switch of both packages for a parity test: ``impl``, given
by ``@pytest.mark.parametrize("impl", [...], indirect=True)``, is the JAX
package's setting and the port's (``runtime.using``) for the test; the JAX
package's goes back to "auto" after it."""

import pytest

from multimodal_embedding_tpu.models import layers as jlayers
from multimodal_embedding_tpu_torch import runtime


@pytest.fixture
def impl(request):
    jlayers.set_attention_impl(request.param)
    with runtime.using(attention=request.param):
        yield request.param
    jlayers.set_attention_impl("auto")

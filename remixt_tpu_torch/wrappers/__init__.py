"""Tool wrappers of the benchmarks.

Counterpart of ``remixt_tpu/wrappers/__init__.py``'s catalog: this
package's own fit (``remixt``) and the external callers TITAN, THetA2 and
cloneHD. Each wrapper's ``create_workflow(seqdata_filenames, breakpoints,
results, workdir, normal_id)`` returns a scheduler Workflow that writes a
results store in the schema the evaluation reads. The external tools
need their binaries on the PATH (their wrappers raise an informative
error otherwise) and run on the host.
"""

from remixt_tpu_torch.wrappers.wrapexternal import (
    CloneHDTool, ThetaTool, TitanTool)
from remixt_tpu_torch.wrappers.wrapremixt import ReMixTTool

catalog = {'remixt': ReMixTTool, 'titan': TitanTool, 'theta': ThetaTool,
           'clonehd': CloneHDTool}

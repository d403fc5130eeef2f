"""Tool wrappers of the benchmarks.

Counterpart of ``remixt_tpu/wrappers/__init__.py``'s catalog. Each
wrapper's ``create_workflow(seqdata_filenames, breakpoints, results,
workdir, normal_id)`` returns a scheduler Workflow that writes a results
store in the schema the evaluation reads. The catalog holds this
package's own fit only: the external tools' wrappers (TITAN, THetA,
cloneHD) are not ported.
"""

from remixt_tpu_torch.wrappers.wrapremixt import ReMixTTool

catalog = {'remixt': ReMixTTool}

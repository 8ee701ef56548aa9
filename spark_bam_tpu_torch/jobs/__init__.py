"""The durable job plane (reference ``spark_bam_tpu/jobs/``): crash-
resumable rewrite, export and transcode.

Long mutations (re-compress a BAM, export it to the columnar container)
get a write-ahead journal (``journal.py``), checkpointed segment output,
a manager with the serve ops' admission (``manager.py``) and an
end-to-end integrity scrubber (``scrub.py``). A job killed at any point
(SIGKILL, ENOSPC, a failing disk) resumes from its last durable
checkpoint, and its final artifact is byte-identical to an uninterrupted
run's. The journal, the segment names and the checkpoint records are the
reference's, so either package resumes the other's job.
"""

from spark_bam_tpu_torch.jobs.journal import (  # noqa: F401
    Journal,
    JournalError,
    SegmentedOutput,
)
from spark_bam_tpu_torch.jobs.manager import JobManager, JobsConfig  # noqa: F401

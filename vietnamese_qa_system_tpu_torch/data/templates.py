"""Vietnamese prompt-template bank for RAG-style QA.

A copy of ``vietnamese_qa_system_tpu/data/templates.py`` (standard library
only), carried into the port so that nothing here imports the JAX package;
the parity tests hold its renders identical to the original for the same
``random.Random``.  Five template families of 20 variants each (retrieval
prompts, normal answers, no-answer refusals, trivial answers, system
prompts) plus the no-docs markers, selected with the caller's seeded RNG
and filled by ``{question}/{context}/{answer}`` substitution; unresolved
placeholders raise.
"""

from __future__ import annotations

import random
from typing import Optional

# --- 20 retrieval prompts: ask the question against retrieved context ------
PROMPT = [
    "Dựa vào các tài liệu sau đây:\n{context}\nHãy trả lời câu hỏi: {question}",
    "Thông tin tham khảo:\n{context}\nCâu hỏi cần trả lời: {question}",
    "Đọc kỹ những đoạn văn dưới đây:\n{context}\nSau đó trả lời: {question}",
    "Cho ngữ cảnh:\n{context}\nTrả lời câu hỏi sau một cách chính xác: {question}",
    "Sử dụng thông tin được cung cấp:\n{context}\nGiải đáp thắc mắc: {question}",
    "Các tài liệu liên quan:\n{context}\nDựa trên đó, hãy cho biết: {question}",
    "Ngữ liệu truy xuất được:\n{context}\nVui lòng trả lời: {question}",
    "Tham khảo nội dung sau:\n{context}\nCâu hỏi: {question}",
    "Dưới đây là những gì tìm được trong cơ sở dữ liệu:\n{context}\nHãy giải đáp: {question}",
    "Bối cảnh:\n{context}\nTừ bối cảnh trên, trả lời: {question}",
    "Hãy dùng các trích đoạn sau để trả lời.\nTrích đoạn:\n{context}\nCâu hỏi: {question}",
    "Câu hỏi: {question}\nTài liệu hỗ trợ:\n{context}\nHãy đưa ra câu trả lời.",
    "Với các thông tin:\n{context}\nAnh/chị hãy trả lời giúp: {question}",
    "Những đoạn văn bản sau có thể hữu ích:\n{context}\nTrả lời câu hỏi này: {question}",
    "Dữ liệu nền:\n{context}\nYêu cầu: trả lời câu hỏi \"{question}\"",
    "Xem xét các nguồn sau:\n{context}\nRồi trả lời ngắn gọn: {question}",
    "Nội dung liên quan đã tìm thấy:\n{context}\nHãy phân tích và trả lời: {question}",
    "Đây là kết quả truy vấn:\n{context}\nDựa vào đó giải thích: {question}",
    "Hãy đọc phần ngữ cảnh:\n{context}\nvà cho biết câu trả lời của: {question}",
    "Từ những tài liệu bên dưới:\n{context}\nbạn hãy trả lời câu hỏi: {question}",
]

# --- 20 normal-answer wrappers ----------------------------------------------
RESPONSE = [
    "Câu trả lời là: {answer}",
    "Dựa trên tài liệu, {answer}",
    "Theo thông tin tìm được: {answer}",
    "{answer}",
    "Từ ngữ cảnh được cung cấp, có thể kết luận: {answer}",
    "Đáp án: {answer}",
    "Theo các nguồn tham khảo, {answer}",
    "Thông tin cho thấy rằng {answer}",
    "Trả lời: {answer}",
    "Căn cứ vào dữ liệu truy xuất, {answer}",
    "Có thể khẳng định: {answer}",
    "Kết quả là {answer}",
    "Như tài liệu đã nêu, {answer}",
    "Nói một cách ngắn gọn: {answer}",
    "Dựa vào những gì được cung cấp: {answer}",
    "Câu trả lời chính xác là {answer}",
    "Theo nội dung trên: {answer}",
    "Phân tích ngữ cảnh cho thấy {answer}",
    "Tóm lại, {answer}",
    "Từ các đoạn văn trên: {answer}",
]

# --- 20 no-answer refusals (question had no supporting docs) ----------------
NO_ANSWER = [
    "Xin lỗi, tôi không tìm thấy thông tin nào phù hợp để trả lời câu hỏi \"{question}\".",
    "Rất tiếc, các tài liệu hiện có không chứa câu trả lời cho: {question}",
    "Tôi không thể trả lời câu hỏi \"{question}\" vì không có dữ liệu liên quan.",
    "Không có tài liệu nào đủ liên quan để giải đáp: {question}",
    "Cơ sở dữ liệu không có thông tin về \"{question}\", mong bạn thông cảm.",
    "Hiện tại tôi chưa có đủ thông tin để trả lời câu hỏi này: {question}",
    "Câu hỏi \"{question}\" nằm ngoài phạm vi các tài liệu tìm được.",
    "Xin lỗi bạn, không có nguồn nào hỗ trợ việc trả lời: {question}",
    "Tôi không dám chắc về \"{question}\" vì thiếu tài liệu tham khảo.",
    "Không tìm thấy ngữ cảnh phù hợp cho câu hỏi \"{question}\".",
    "Dữ liệu truy xuất không giúp trả lời được: {question}",
    "Thành thật xin lỗi, tôi không có thông tin về \"{question}\".",
    "Với những gì hiện có, tôi không thể giải đáp \"{question}\".",
    "Các nguồn được cung cấp không đề cập đến: {question}",
    "Tiếc là câu hỏi \"{question}\" chưa thể được trả lời từ dữ liệu này.",
    "Tôi chưa tìm ra câu trả lời đáng tin cậy cho: {question}",
    "Không đủ căn cứ trong tài liệu để trả lời \"{question}\".",
    "Câu hỏi này (\"{question}\") vượt quá thông tin tôi đang có.",
    "Rất tiếc phải nói rằng không có tài liệu nào khớp với: {question}",
    "Hệ thống không truy xuất được nội dung nào cho câu hỏi \"{question}\".",
]

# --- 20 trivial answers (no docs needed; answer directly) -------------------
TRIVIAL = [
    "Câu này không cần tài liệu: {answer}",
    "Đây là kiến thức phổ thông, câu trả lời cho \"{question}\" là {answer}.",
    "Không cần tra cứu, {answer}",
    "Trả lời nhanh: {answer}",
    "Với câu hỏi \"{question}\", đáp án đơn giản là {answer}.",
    "Dễ thôi: {answer}",
    "{answer} — đây là câu trả lời trực tiếp cho \"{question}\".",
    "Câu hỏi quen thuộc, xin trả lời: {answer}",
    "Không cần ngữ cảnh, tôi có thể khẳng định: {answer}",
    "Theo hiểu biết chung: {answer}",
    "Câu trả lời hiển nhiên là {answer}.",
    "Ai cũng biết rằng {answer}",
    "Xin trả lời ngay: {answer}",
    "Đáp án cho \"{question}\" là: {answer}",
    "Đơn giản là {answer}.",
    "Kiến thức cơ bản: {answer}",
    "Trả lời mà không cần tài liệu: {answer}",
    "Về câu \"{question}\": {answer}",
    "Tôi trả lời trực tiếp nhé: {answer}",
    "Không phải tra cứu gì thêm, {answer}",
]

# --- 20 generic system prompts ----------------------------------------------
SYSTEM = [
    "Bạn là một trợ lý AI hữu ích, trả lời trung thực bằng tiếng Việt.",
    "Bạn là trợ lý trả lời câu hỏi dựa trên tài liệu được cung cấp.",
    "Hãy đóng vai một chuyên gia tra cứu thông tin cẩn thận và chính xác.",
    "Bạn là hệ thống hỏi đáp tiếng Việt; chỉ trả lời khi có căn cứ.",
    "Là một trợ lý thông minh, bạn luôn giải thích rõ ràng và ngắn gọn.",
    "Bạn là trợ lý ảo thân thiện, giúp người dùng tìm câu trả lời đúng.",
    "Nhiệm vụ của bạn: đọc ngữ cảnh và trả lời câu hỏi một cách trung thực.",
    "Bạn là mô hình ngôn ngữ được huấn luyện để hỗ trợ hỏi đáp tiếng Việt.",
    "Hãy trả lời như một giáo viên kiên nhẫn, dựa trên tài liệu tham khảo.",
    "Bạn là trợ lý nghiên cứu, luôn trích dẫn thông tin từ ngữ cảnh.",
    "Vai trò của bạn là cung cấp câu trả lời chính xác, không bịa đặt.",
    "Bạn là một AI lễ phép, trả lời đầy đủ nhưng súc tích.",
    "Hãy hành xử như một thủ thư am hiểu, tìm đúng thông tin cần thiết.",
    "Bạn là trợ lý đa ngôn ngữ nhưng ưu tiên trả lời bằng tiếng Việt.",
    "Là một hệ thống RAG, bạn chỉ dùng tài liệu truy xuất để trả lời.",
    "Bạn là cố vấn đáng tin cậy; nếu không chắc chắn hãy nói không biết.",
    "Trợ lý AI đây! Tôi sẽ giúp bạn trả lời dựa trên dữ liệu có sẵn.",
    "Bạn được thiết kế để hỗ trợ người Việt tra cứu kiến thức nhanh chóng.",
    "Hãy là một trợ lý khách quan, phân biệt rõ sự thật và suy đoán.",
    "Bạn là bộ máy hỏi đáp: nhận câu hỏi, đọc ngữ cảnh, đưa ra đáp án.",
]

# --- no-docs markers (capability of NO_DOCS_MESSAGE, response_template.py) --
NO_DOCS = [
    "Không truy xuất được tài liệu nào đạt ngưỡng điểm cho câu hỏi này.",
    "Kho dữ liệu không có đoạn văn nào phù hợp với câu hỏi.",
]

FAMILIES = {
    "prompt": PROMPT,
    "response": RESPONSE,
    "no_answer": NO_ANSWER,
    "trivial": TRIVIAL,
    "system": SYSTEM,
    "no_docs": NO_DOCS,
}


class TemplateBank:
    """Deterministic template selection + substitution.

    ``render(family, id, ...)`` fills a specific template;
    ``render_random(family, rng, ...)`` picks uniformly with the caller's
    ``random.Random`` (reference used module-global random — here RNG is
    explicit so dataset builds are reproducible).
    """

    def __init__(self, families: Optional[dict] = None):
        self.families = families or FAMILIES

    def size(self, family: str) -> int:
        return len(self.families[family])

    def render(self, family: str, template_id: int, **fields) -> str:
        bank = self.families.get(family)
        if bank is None:
            raise KeyError(f"unknown template family {family!r}")
        if not 0 <= template_id < len(bank):
            raise IndexError(
                f"template id {template_id} out of range for {family!r} "
                f"(0..{len(bank) - 1})"
            )
        text = bank[template_id]
        try:
            return text.format(**fields)
        except KeyError as e:
            raise KeyError(
                f"template {family}[{template_id}] needs field {e}"
            ) from None

    def render_random(self, family: str, rng: random.Random, **fields) -> str:
        tid = rng.randrange(len(self.families[family]))
        return self.render(family, tid, **fields)


DEFAULT_BANK = TemplateBank()
